"""Unified config system: one dataclass tree, JSON/YAML load, dotted-key
CLI overrides.

Port of signnet_basisnet_tpu/training/config.py with the same schema, so the
JAX package's configs load unchanged:

    python -m signnet_basisnet_tpu_torch.train_zinc \
        --config configs/gin_zinc_signinv_gin.json \
        data.agg_backend pallas_tile train.epochs 1

`train.num_microbatches`, which the JAX train_zinc never reads, is kept
in the schema and refused by train_zinc above 1.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence


@dataclass
class TrainConfig:
    seed: int = 41
    epochs: int = 1000
    batch_size: int = 128
    init_lr: float = 1e-3
    lr_reduce_factor: float = 0.5
    lr_schedule_patience: int = 25
    min_lr: float = 1e-6
    weight_decay: float = 0.0
    max_time_hours: float = 12.0
    print_epoch_interval: int = 5
    num_microbatches: int = 1       # data-parallel microbatches per step
    mp: int = 1                     # model-parallel shards (parallel/mp_halo):
    #   nodes+edges partitioned over an mp mesh axis with per-layer
    #   neighbor-only halo exchange; params replicated
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 2
    resume: bool = False            # restore latest checkpoint before fit
    log_dir: Optional[str] = None
    # f32 matmul precision, jax.default_matmul_precision's names: None /
    # 'float32' / 'highest' full f32, 'tensorfloat32' / 'high' TF32,
    # 'bfloat16' / 'default' torch's 'medium' (train_zinc.MATMUL_PRECISION)
    matmul_precision: Optional[str] = None
    # mixed precision: forward/backward in this dtype, f32 master params,
    # optimizer and loss ('bfloat16'; default full f32)
    compute_dtype: Optional[str] = None
    # BN statistics at eval: 'running' = torch model.eval() semantics
    # (reference protocols); 'batch' = track_running_stats=False semantics,
    # robust to BN dead-channel revival (RESULTS.md r3)
    eval_bn_mode: str = "running"


@dataclass
class ModelConfig:
    model: str = "GIN"              # registry name
    hidden_dim: int = 95
    out_dim: int = 95
    n_layers: int = 16
    readout: str = "mean"
    in_feat_dropout: float = 0.0
    dropout: float = 0.0
    batch_norm: bool = True
    residual: bool = True
    edge_feat: bool = True
    pe_init: str = "lap_pe"
    lap_method: str = "sign_inv"
    # reference flips eigvec signs at eval time too (handle_lap from
    # evaluate_network_sparse); default replicates that for sign_flip runs
    eval_sign_flip: bool = True
    pos_enc_dim: int = 8
    sign_inv_net: str = "gin"
    sign_inv_layers: int = 8
    phi_out_dim: int = 4
    pe_aggregate: str = "add"
    num_heads: int = 8
    towers: int = 5
    full_graph: bool = False
    layer_norm: bool = False
    gru: bool = False               # PNA: GRU between layers
    no_towers: bool = False         # PNA: DGN-style towerless layers
    use_lspe: bool = False          # learned structural+positional channels
    use_lapeig_loss: bool = False   # Laplacian-eigvec auxiliary loss on p
    alpha_loss: float = 1e-4
    lambda_loss: float = 1.0
    max_nodes: int = 40             # dense n_max (transformer phi)
    remat: bool = False             # recompute each conv layer (not ported)
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DataConfig:
    dataset: str = "ZINC"
    data_dir: str = "data/zinc"
    subset: bool = True
    synthetic_fallback: bool = True
    synth_train: int = 10000
    synth_eval: int = 1000
    pe_mode: str = "lap_pe"         # lap_pe | full_evd | rwpe | none
    evd_normalization: Optional[str] = None
    batch_align: int = 8
    batch_slack: float = 1.10
    tile: Optional[int] = None      # tile-local packing (batch_np(tile=bn))
    agg_backend: str = "xla"        # xla | pallas_tile | tile_dense (graph.segment)


@dataclass
class Config:
    train: TrainConfig = field(default_factory=TrainConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    out_dir: str = "out"
    name: str = "run"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), indent=2)


def _set_dotted(cfg: Any, key: str, value: str) -> None:
    parts = key.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    leaf = parts[-1]
    if isinstance(obj, dict):
        obj[leaf] = _parse_value(value)
        return
    cur = getattr(obj, leaf)
    setattr(obj, leaf, _coerce(value, cur))


def _parse_value(v: str) -> Any:
    try:
        return json.loads(v)
    except (json.JSONDecodeError, ValueError):
        return v


def _coerce(v: str, current: Any) -> Any:
    if isinstance(current, bool):
        return v.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(v)
    if isinstance(current, float):
        return float(v)
    if current is None or isinstance(current, (dict, list)):
        return _parse_value(v)
    return v


def _update_dataclass(obj: Any, d: dict) -> None:
    for k, v in d.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key {k!r} on {type(obj).__name__}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _update_dataclass(cur, v)
        else:
            setattr(obj, k, v)


def load_config(path: Optional[str] = None,
                overrides: Sequence[str] = ()) -> Config:
    """Load JSON/YAML config file and apply `key value` CLI override pairs."""
    cfg = Config()
    if path:
        with open(path) as f:
            if path.endswith((".yaml", ".yml")):
                import yaml
                d = yaml.safe_load(f)
            else:
                d = json.load(f)
        _update_dataclass(cfg, d)
    if len(overrides) % 2 != 0:
        raise ValueError("overrides must be `key value` pairs")
    for k, v in zip(overrides[::2], overrides[1::2]):
        _set_dotted(cfg, k, v)
    return cfg
