"""FCHarDNet-70 semantic segmentation network, NCHW.

Counterpart of ``panoptic_forecasting_tpu/models/hardnet.py``, plain
graph only (reference ``models/bg/hardnet.py``, itself the public
FCHarDNet): a 4-conv stem, 5 HarDBlocks with 1×1 transitions and 2×2
average-pool downsampling, a 4-stage decoder of align-corners bilinear
upsample + skip concat + 1×1 halving conv + HarDBlock, a 1×1 class head
and a bilinear resize to the input (or ``final_size``).

Module names follow the reference's ``state_dict`` (``base.{i}`` with the
parameterless AvgPool slots counted, ``conv1x1_up.{j}``,
``denseBlocksUp.{j}``, ``finalConv``), so reference checkpoints and the
JAX importer (``reference_import.bg_from_reference``) line up by name.
The JAX package's TPU layout variants (``packed_*``, ``stem_s2d``) are
exact re-indexings of this graph and are not ported.

``folded=True`` is the inference graph: every ConvLayer is a conv with
bias and no BatchNorm (``fold_batchnorm_``). The unfolded graph trains:
its BatchNorm (``BatchNorm2d``) keeps flax's statistics.

``dtype=torch.bfloat16`` is the JAX package's ``dtype=jnp.bfloat16``
(JAX hardnet.py:415-530, 655-700, 770-800), with explicit casts at JAX's
points, rounding where XLA rounds them: the parameters stay f32; each
conv casts its input and weight to bf16; a folded conv rounds its
result to bf16 and adds the bias, cast to bf16, in bf16; an unfolded
one hands its f32 accumulator to BatchNorm, which computes its
statistics and the normalisation in f32 and returns bf16 (flax's
``nn.BatchNorm(dtype=bf16)``, whose first op promotes the conv's output
to f32); the average pool adds its four bf16 terms one by one (XLA's
bf16 ``reduce_window``); the decoder's interpolation matrix is rounded
to bf16; the logits go back to f32 before the final resize and the
argmax.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_sum, batch_is_sharded


# FCHarDNet-70 (hardnet.py:261-327)
FIRST_CH = (16, 24, 32, 48)
CH_LIST = (64, 96, 160, 224, 320)
GRMUL = 1.7
GR = (10, 16, 18, 24, 32)
N_LAYERS = (4, 4, 8, 8, 8)


def hard_block_links(n_layers: int, base_ch: int, growth: int, grmul: float):
    """Per-layer (out_ch, in_ch, link) + block out channels (the harmonic
    link rule, hardnet.py:177-194)."""

    def get_link(layer):
        if layer == 0:
            return base_ch, 0, []
        out_channels = float(growth)
        link = []
        for i in range(10):
            dv = 2 ** i
            if layer % dv == 0:
                link.append(layer - dv)
                if i > 0:
                    out_channels *= grmul
        out_channels = int(int(out_channels + 1) / 2) * 2
        in_channels = sum(get_link(l)[0] for l in link)
        return out_channels, in_channels, link

    layers = [get_link(i + 1) for i in range(n_layers)]
    out_ch = sum(
        oc for i, (oc, _, _) in enumerate(layers)
        if i % 2 == 0 or i == n_layers - 1
    )
    return layers, out_ch


def _interp_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_out, n_in) align_corners=True linear-interpolation matrix: row
    o holds (1 - w) at lo(o) and w at hi(o)."""
    if n_out == 1 or n_in == 1:
        r = torch.zeros((n_out, n_in), dtype=torch.float32, device=device)
        r[:, 0] = 1
        return r
    src = torch.arange(n_out, dtype=torch.float32, device=device) * (n_in - 1) / (n_out - 1)
    lo = torch.floor(src).to(torch.int64).clamp(0, n_in - 1)
    hi = (lo + 1).clamp(0, n_in - 1)
    w = src - lo.to(torch.float32)
    cols = torch.arange(n_in, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return (torch.where(cols == lo[:, None], (1 - w)[:, None], zero)
            + torch.where(cols == hi[:, None], w[:, None], zero))


def resize_bilinear_hw(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Align-corners bilinear resize of (..., H, W) as two small matrix
    products; equals ``F.interpolate(mode='bilinear', align_corners=True)``
    to f32 rounding."""
    h_in, w_in = x.shape[-2:]
    h_out, w_out = size
    if h_out != h_in:
        x = torch.matmul(_interp_matrix(h_in, h_out, x.device).to(x.dtype), x)
    if w_out != w_in:
        x = torch.matmul(x, _interp_matrix(w_in, w_out, x.device).to(x.dtype).t())
    return x


class AvgPool2(nn.Module):
    """The reference's ``nn.AvgPool2d(2, 2)`` slot of ``base``. In bf16 the
    four taps are added one at a time in bf16 and the sum divided by 4,
    as flax's ``nn.avg_pool`` reduces a bf16 window."""

    def forward(self, x):
        if x.dtype != torch.bfloat16:
            return F.avg_pool2d(x, 2, 2)
        h, w = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
        s = x[..., 0:h:2, 0:w:2] + x[..., 0:h:2, 1:w:2]
        s = s + x[..., 1:h:2, 0:w:2]
        s = s + x[..., 1:h:2, 1:w:2]
        return s / 4


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's semantics (JAX ``ConvLayer``'s
    ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``), under
    ``nn.BatchNorm2d``'s state names.

    In training the batch is normalised as flax does it: the statistics
    are the batch mean and flax's variance ``max(0, E[x²] − E[x]²)``
    (biased, and one pass: where the mean is large against the spread
    this rounds otherwise than a two-pass variance, and through 70
    layers the logits move far beyond f32 rounding), and ``y = (x − mean) ·
    (γ · rsqrt(var + ε)) + β``. The running statistics move as ``0.9 · r
    + 0.1 · s`` with those statistics (``nn.BatchNorm2d`` moves them
    with the unbiased variance, and raises on one value per channel,
    where this variance is 0). In eval mode the running statistics
    normalise.

    On a sharded batch (``parallel/mesh.py::batch_is_sharded``: this
    rank holds its share of the global batch) the statistics are the
    global batch's, as flax takes them over JAX's sharded batch axis:
    one all-reduce of ``[Σx, Σx², n]`` a layer (``all_reduce_sum``,
    whose backward all-reduces the gradient), then ``mean = Σx/n`` and
    ``var = max(0, Σx²/n − mean²)``; the running statistics move with
    them, equal on every rank. Otherwise no collective runs.

    In a bf16 network (``HarDNet(dtype=torch.bfloat16)``) the f32 conv
    accumulator comes in and ``out_dtype=torch.bfloat16`` goes out, as
    flax's ``nn.BatchNorm(dtype=bf16)`` computes: the statistics, their
    all-reduce and the normalisation in f32, the result cast to bf16.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)

    def forward(self, x, out_dtype: Optional[torch.dtype] = None):
        """``out_dtype`` (bf16) casts the normalised f32 result."""
        if not self.training:
            if out_dtype is None:
                return F.batch_norm(x, self.running_mean, self.running_var,
                                    self.weight, self.bias, False, 0.0, self.eps)
            return self._normalize(x, self.running_mean,
                                   self.running_var).to(out_dtype)
        dims = (0, 2, 3)
        if batch_is_sharded():
            c = x.shape[1]
            n = x.new_full((1,), x.numel() // c)
            total = all_reduce_sum(torch.cat([x.sum(dims), (x * x).sum(dims), n]))
            mean = total[:c] / total[2 * c]
            var = torch.clamp(total[c: 2 * c] / total[2 * c] - mean * mean, min=0.0)
        else:
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
            self.running_var.copy_(0.9 * self.running_var + 0.1 * var)
            self.num_batches_tracked.add_(1)
        y = self._normalize(x, mean, var)
        return y if out_dtype is None else y.to(out_dtype)

    def _normalize(self, x, mean, var):
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class _ConvBF16(torch.autograd.Function):
    """JAX's bf16 conv as XLA computes it: the input and the f32 weight
    rounded to bf16, the conv's result rounded to bf16, the bias cast to
    bf16 and added in bf16. The gradients of the f32 weight and bias are
    f32: XLA keeps the f32 accumulators of the transposed conv and of the
    bias sum where the cast to the f32 parameter follows them."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        xb, wb = x.to(torch.bfloat16), weight.to(torch.bfloat16)
        y = F.conv2d(xb, wb, None, stride, padding)
        if bias is not None:
            y = y + bias.to(torch.bfloat16)[:, None, None]
        ctx.save_for_backward(xb, wb)
        ctx.conf = (stride, padding, x.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        xb, wb = ctx.saved_tensors
        stride, padding, x_dtype = ctx.conf
        d = dy.to(torch.float32)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(xb.shape, wb.to(torch.float32), d,
                                            stride, padding).to(x_dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(xb.to(torch.float32), wb.shape, d,
                                             stride, padding)
        if ctx.needs_input_grad[2]:
            db = d.sum((0, 2, 3))
        return dx, dw, db, None, None


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)``; for a bf16 ``x`` JAX's bf16 conv with its bias
    (``_ConvBF16``)."""
    if x.dtype != torch.bfloat16:
        return conv(x)
    return _ConvBF16.apply(x, conv.weight, conv.bias, conv.stride, conv.padding)


def conv2d_f32_out(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A bias-free conv of bf16 ``x`` with the weight rounded to bf16, its
    f32 accumulator not rounded: what JAX's bf16 conv hands to a BatchNorm,
    whose first op promotes it to f32 (XLA keeps the accumulator there).
    The products of bf16 values are exact in f32, so an f32 conv of the
    rounded operands computes it. The weight's gradient stays the f32
    accumulator too (the rounding is taken out of the backward)."""
    w = conv.weight
    w = w + (w.to(torch.bfloat16).to(torch.float32) - w).detach()
    return F.conv2d(x.to(torch.float32), w, None, conv.stride, conv.padding)


class ConvLayer(nn.Module):
    """conv (no bias, k//2 padding) -> BN -> ReLU (hardnet.py:16-25); with
    ``folded`` a conv with bias -> ReLU. It computes in its input's
    dtype; in bf16 the unfolded layer's BN takes the conv's f32
    accumulator (``conv2d_f32_out``) and returns bf16."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, folded: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2,
                              bias=folded)
        self.norm = None if folded else BatchNorm2d(out_ch)

    def forward(self, x):
        if self.norm is None:
            return F.relu(conv2d(self.conv, x))
        if x.dtype == torch.bfloat16:
            return F.relu(self.norm(conv2d_f32_out(self.conv, x),
                                    out_dtype=torch.bfloat16))
        return F.relu(self.norm(self.conv(x)))


class HarDBlock(nn.Module):
    def __init__(self, in_ch: int, growth: int, grmul: float, n_layers: int,
                 folded: bool = False):
        super().__init__()
        specs, self.out_channels = hard_block_links(
            n_layers, in_ch, growth, grmul
        )
        self.links = [link for _, _, link in specs]
        self.layers = nn.ModuleList(
            ConvLayer(ic, oc, folded=folded) for oc, ic, _ in specs
        )

    def forward(self, x):
        outs = [x]
        for link, layer in zip(self.links, self.layers):
            tin = [outs[l] for l in link]
            outs.append(layer(torch.cat(tin, 1) if len(tin) > 1 else tin[0]))
        t = len(outs)
        return torch.cat(
            [outs[i] for i in range(t) if i == t - 1 or i % 2 == 1], 1
        )


class HarDNet(nn.Module):
    """FCHarDNet-70 over (B, C_in, H, W); logits at the input (or
    ``final_size``) resolution, or their argmax. ``dtype`` is the compute
    dtype of every layer (f32 or bf16); the parameters stay f32."""

    def __init__(self, in_channels: int, n_classes: int = 19,
                 folded: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.folded = folded
        self.dtype = dtype
        first_ch, ch_list, grmul, gr, n_layers = FIRST_CH, CH_LIST, GRMUL, GR, N_LAYERS
        blks = len(n_layers)
        base: List[nn.Module] = [
            ConvLayer(in_channels, first_ch[0], 3, 2, folded),
            ConvLayer(first_ch[0], first_ch[1], 3, 1, folded),
            ConvLayer(first_ch[1], first_ch[2], 3, 2, folded),
            ConvLayer(first_ch[2], first_ch[3], 3, 1, folded),
        ]
        skip_chs = []
        self.skip_after = []  # base indices whose output feeds the decoder
        ch = first_ch[3]
        for i in range(blks):
            blk = HarDBlock(ch, gr[i], grmul, n_layers[i], folded)
            ch = blk.out_channels
            base.append(blk)
            if i < blks - 1:
                skip_chs.append(ch)
                self.skip_after.append(len(base) - 1)
            base.append(ConvLayer(ch, ch_list[i], 1, 1, folded))
            ch = ch_list[i]
            if i < blks - 1:
                # torch keeps the AvgPool in the ModuleList: it takes an index
                base.append(AvgPool2())
        self.base = nn.ModuleList(base)
        ups, dense_up = [], []
        prev_ch = ch
        for i in range(blks - 2, -1, -1):
            cur = prev_ch + skip_chs[i]
            ups.append(ConvLayer(cur, cur // 2, 1, 1, folded))
            blk = HarDBlock(cur // 2, gr[i], grmul, n_layers[i], folded)
            dense_up.append(blk)
            prev_ch = blk.out_channels
        self.conv1x1_up = nn.ModuleList(ups)
        self.denseBlocksUp = nn.ModuleList(dense_up)
        self.finalConv = nn.Conv2d(prev_ch, n_classes, 1, bias=True)

    def forward(self, x, final_size: Optional[Tuple[int, int]] = None,
                return_argmax: bool = False, skip_stem0: bool = False):
        """x (B, C_in, H, W) -> f32 logits (B, n_classes, H', W') or, with
        ``return_argmax``, the (B, H', W') int32 argmax (first index on
        ties). ``skip_stem0``: x is already base.0's output (the fused
        one-hot stem computed it). x is cast to the compute dtype first
        (JAX hardnet.py:662)."""
        if skip_stem0:
            size_in = (x.shape[-2] * 2, x.shape[-1] * 2)
        else:
            size_in = (x.shape[-2], x.shape[-1])
        # the compute dtype: bf16, else the parameters' (f32; float64
        # after ``.double()``)
        x = x.to(torch.bfloat16 if self.dtype == torch.bfloat16
                 else self.finalConv.weight.dtype)
        skips = []
        for i, layer in enumerate(self.base):
            if i == 0 and skip_stem0:
                continue
            x = layer(x)
            if i in self.skip_after:
                skips.append(x)
        for up, blk in zip(self.conv1x1_up, self.denseBlocksUp):
            skip = skips.pop()
            x = resize_bilinear_hw(x, tuple(skip.shape[-2:]))
            x = blk(up(torch.cat([x, skip], 1)))
        logits = conv2d(self.finalConv, x)
        if logits.dtype == torch.bfloat16:
            logits = logits.float()
        out = resize_bilinear_hw(logits, final_size or size_in)
        if return_argmax:
            return torch.argmax(out, 1).to(torch.int32)
        return out


def fold_batchnorm_(net: HarDNet) -> HarDNet:
    """Fold every BN of ``net`` into its conv, in place (-> ``folded``):

        weight' = weight · γ/√(var+ε),   bias' = β − mean · γ/√(var+ε)

    (JAX ``fold_batchnorm_variables``; the reference's dead
    ``v2_transform``, hardnet.py:341-351). Exact up to f32 rounding.
    """
    net.folded = True
    for module in net.modules():
        if isinstance(module, ConvLayer) and module.norm is not None:
            conv, bn = module.conv, module.norm
            with torch.no_grad():
                scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
                conv.weight.mul_(scale[:, None, None, None])
                conv.bias = nn.Parameter(bn.bias - bn.running_mean * scale)
            module.norm = None
    return net
