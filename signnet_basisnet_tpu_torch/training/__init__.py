from .checkpoint import Checkpointer, load_train_state, train_state
from .config import Config, load_config
from . import metrics
from .metrics import masked_l1
from .optim import ReduceLROnPlateau, StepLR, adam, set_lr
from .train import (FitResult, KFoldResult, build_steps, capture_train_step,
                    count_params, evaluate, fit, k_fold_split, l1_graph_loss,
                    make_lapeig_loss_fn, make_module_predict,
                    make_zinc_predict, run_k_fold)
