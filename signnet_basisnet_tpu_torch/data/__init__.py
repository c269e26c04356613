from .batcher import choose_budgets, iterate_graphbatches, pack_batches
from .zinc import (ZINC_NUM_ATOM_TYPE, ZINC_NUM_BOND_TYPE, add_full_evd,
                   add_lap_pe, add_rwpe, avg_degree_stats, load_zinc,
                   load_zinc_pickle, synthetic_zinc)
