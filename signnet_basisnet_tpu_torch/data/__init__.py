from .batcher import choose_budgets, iterate_graphbatches, pack_batches
from .zinc import (ZINC_NUM_ATOM_TYPE, ZINC_NUM_BOND_TYPE, add_lap_pe,
                   load_zinc, load_zinc_pickle, synthetic_zinc)
