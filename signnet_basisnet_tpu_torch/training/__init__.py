from .checkpoint import Checkpointer, load_train_state, train_state
from .config import Config, load_config
from .metrics import masked_l1
from .optim import ReduceLROnPlateau, StepLR, adam, set_lr
from .train import (FitResult, build_steps, capture_train_step, count_params,
                    evaluate, fit, l1_graph_loss, make_lapeig_loss_fn,
                    make_zinc_predict)
