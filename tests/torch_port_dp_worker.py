"""One rank of tests/test_torch_port_parallel.py's data-parallel runs (not
a test module). It imports the port only, never JAX.

    python torch_port_dp_worker.py JOB SPEC RANK

SPEC is a ``torch.save``d dict the test wrote (``addr``, ``world`` and
the job's inputs); the rank writes its results to ``SPEC.rank{RANK}``.
Jobs:

* ``rendezvous``: join through the coordinator flags of ``load_config``
  and report rank, world size, ``is_main_process``, the rows
  ``shard_rows`` gives and the trainer's metric means over a sharded and
  a replicated batch; rank 1 prints once plainly (silenced) and once
  with ``force=True``;
* ``step``: for each case (a model's config, card, weights, global batch
  and dtype) one training step on this rank's rows: loss, metrics,
  gradient all-reduce, optimizer step; the bg case also under two wrong
  rules, per-rank BN statistics and the mean of per-rank loss means;
* ``train``: ``cli.train.main`` with the coordinator flags; rank 1
  records every file it opens for writing, creates or renames under the
  working dir (``sys.addaudithook``); with ``stand_in`` the step graphs'
  capture is stood in for on the CPU (``test_torch_port_train_graph.py``).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from panoptic_forecasting_tpu_torch.core.config import load_config  # noqa: E402
from panoptic_forecasting_tpu_torch.parallel import mesh  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


def dist_flags(spec, rank):
    return ["--distributed", "--coordinator_address", spec["addr"], "--num_processes",
            str(spec["world"]), "--process_id", str(rank)]


def join(spec, rank):
    cfg = load_config(["--working_dir", spec.get("working_dir", "unused"),
                       "--set", "platform", "cpu"] + dist_flags(spec, rank))
    assert mesh.init_distributed(cfg)
    return cfg


def rendezvous(spec, rank):
    from panoptic_forecasting_tpu_torch.train.loop import _Sums

    join(spec, rank)
    print(f"RANK{rank} PLAIN")
    # process 0 keeps the plain builtin, which takes no force
    print(f"RANK{rank} FORCED", **({"force": True} if rank else {}))
    sums = _Sums()
    # a sharded batch of per-sample losses: rank r holds rows 2r, 2r+1
    sums.add({"loss": torch.tensor([1.0, 2.0]) + 2 * rank}, sharded=True)
    # a replicated batch: every rank holds the same three rows
    sums.add({"loss": torch.tensor([10.0, 20.0, 30.0])}, sharded=False)
    scalar = _Sums()  # bg's scalars: each rank's share of the batch's value
    scalar.add({"loss": torch.tensor(0.25 + 0.5 * rank)}, sharded=True)
    scalar.add({"loss": torch.tensor(4.0)}, sharded=False)
    return {"rank": mesh.rank(), "world": mesh.world_size(),
            "main": mesh.is_main_process(), "rows": list(mesh.shard_rows(list(range(6)))),
            "ragged": list(mesh.shard_rows(list(range(5)))),
            "vector_means": sums.means(), "scalar_means": scalar.means()}


def _rows(tree, rows):
    if isinstance(tree, dict):
        return {k: _rows(v, rows) for k, v in tree.items()}
    return np.asarray(tree)[rows]


def one_step(case, rank, sharded_bn=True, global_count=True, average=None):
    """One step of the case's model on this rank's rows -> its results."""
    from panoptic_forecasting_tpu_torch.core import build_model
    from panoptic_forecasting_tpu_torch.core.checkpoint import load_weights
    from panoptic_forecasting_tpu_torch.data.cards import DataCard
    from panoptic_forecasting_tpu_torch.models import bg, hardnet
    from panoptic_forecasting_tpu_torch.train.loop import _Sums, to_device
    from panoptic_forecasting_tpu_torch.train.optim import build_optimizer

    model = build_model(case["cfg"], DataCard.from_json(case["card"]), "cpu")
    load_weights(model, case["state"])
    model.to(case["dtype"]).train()
    rows = mesh.shard_rows(np.arange(case["n"]))
    local = _rows(case["batch"], rows)
    saved = hardnet.batch_is_sharded, bg.batch_is_sharded
    if not sharded_bn:  # each rank's BN normalises by its own statistics
        hardnet.batch_is_sharded = lambda: False
    if not global_count:  # each rank's loss is its own pixels' mean
        bg.batch_is_sharded = lambda: False
    try:
        with mesh.sharded_batch(len(rows) < case["n"]):
            loss, metrics = model.loss(to_device(local, CPU))
    finally:
        hardnet.batch_is_sharded, bg.batch_is_sharded = saved
    loss.backward()
    if average is None:
        average = not model.loss_adds_over_shards
    mesh.all_reduce_grads(list(model.parameters()), average=average)
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
             for k, p in model.named_parameters()}
    sums = _Sums()
    sums.add(metrics, sharded=True)
    build_optimizer(model, case["cfg"]).step()
    return {"rows": len(rows), "loss": float(loss.detach()),
            "means": sums.means(), "grads": grads,
            "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}


def step(spec, rank):
    join(spec, rank)
    out = {}
    for case in spec["cases"]:
        out[case["name"]] = one_step(case, rank)
        if case["name"] == "bg":
            out["bg_per_rank_bn"] = one_step(case, rank, sharded_bn=False)
            out["bg_mean_of_means"] = one_step(case, rank, global_count=False,
                                               average=True)
    return out


def train(spec, rank):
    from panoptic_forecasting_tpu_torch.cli import train as train_cli

    wd = os.path.abspath(spec["working_dir"])
    writes = []

    def audit(event, args):
        if event == "open" and args[1] is not None and any(c in str(args[1]) for c in "wax+"):
            path = args[0]
        elif event in ("os.mkdir", "os.rename", "os.remove", "shutil.rmtree"):
            path = args[0]
        else:
            return
        if isinstance(path, (str, bytes, os.PathLike)):
            path = os.path.abspath(os.fsdecode(path))
            if path == wd or path.startswith(wd + os.sep):
                writes.append((event, path))

    if rank != 0:
        sys.addaudithook(audit)
    if spec.get("stand_in"):  # the step graphs' capture stood in for on the CPU
        from panoptic_forecasting_tpu_torch.train import graph

        graph.DEVICE_TYPE = "cpu"
        graph.capture = lambda fn, pool=None: (fn, pool)
    result = train_cli.main(spec["argv"] + dist_flags(spec, rank))
    found = list(writes)  # before this rank's own result file is written
    return {"history": result["history"], "step": result["step"],
            "best_val_epoch": result["best_val_epoch"],
            "state": {k: v.detach().clone() for k, v in result["model"].state_dict().items()},
            "writes": found, "graph": result["graph"]}


JOBS = {"rendezvous": rendezvous, "step": step, "train": train}


def main():
    job, spec_path, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
    spec = torch.load(spec_path, weights_only=False)
    out = JOBS[job](spec, rank)
    mesh.barrier()
    torch.save(out, f"{spec_path}.rank{rank}")


if __name__ == "__main__":
    main()
