from .config import Config, load_config
from .metrics import masked_l1
from .optim import ReduceLROnPlateau, adam, set_lr
from .train import (FitResult, build_steps, count_params, evaluate, fit,
                    l1_graph_loss, make_zinc_predict)
