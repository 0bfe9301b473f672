from .config import Config, apply_dotted_override, coerce_value, load_config, merge_config
from .registry import build_dataset, build_model, register_dataset, register_model
