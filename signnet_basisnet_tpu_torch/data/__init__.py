from .alchemy import (ALCHEMY_NUM_TARGETS, load_alchemy, load_tudataset,
                      standardize_targets, synthetic_alchemy)
from .batcher import (choose_budgets, code_columns, iterate_graphbatches,
                      pack_batches, plan_batches, stack_microbatches)
from .zinc import (ZINC_NUM_ATOM_TYPE, ZINC_NUM_BOND_TYPE, add_full_evd,
                   add_lap_pe, add_rwpe, avg_degree_stats, load_zinc,
                   load_zinc_pickle, synthetic_zinc)
from .twodgrid import FILTERS, filter_labels, filter_response, load_twodgrid
from .transforms import make_full_graph, make_full_graphs
