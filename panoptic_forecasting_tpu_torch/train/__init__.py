from .loop import train
from .optim import build_optimizer, lr_for_epoch
