"""The yardstick's arithmetic against hand counts at small sizes, and each
configuration's kernel schedule against the launches the program makes."""
import json
import os

import pytest
import torch

from harness import costs
from harness.spec import load_module

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name, **model):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["model"].update(model)
    return cfg


def test_signnet_flops_by_hand():
    # k = 1, hidden 2, phi_out 1, 2 layers; 3 nodes, 4 edges
    mm, agg = costs.signnet({"nodes": 3, "edges": 4, "graphs": 1}, 1, 2, 1,
                            2)
    rows = 2 * 1 * 3
    # phi layer 0: d 1 -> 2 -> 2; layer 1: 2 -> 2 -> 1
    phi = 2 * rows * (1 * 2 + 2 * 2) + 2 * rows * (2 * 2 + 2 * 1)
    # rho: 1 -> 2 -> 1 over 3 nodes
    rho = 2 * 3 * (1 * 2 + 2 * 1)
    assert mm == phi + rho
    assert agg == 2 * 4 * 1 + 2 * 4 * 2


def test_train_flops_and_embedding_by_hand():
    mm, agg = costs.embed_and_readout({"nodes": 5, "edges": 0, "graphs": 2},
                                      k=2, hidden=4, out=8)
    assert mm == 2 * 5 * 2 * 4 + 2 * 5 * 8 * 4 + 2 * 2 * (8 * 4 + 4 * 2 + 2)
    assert agg == 5 * 8
    assert costs.train_flops(10.0, 3.0, 7) == 10 + 3 + 20 + 3 + 84


def test_gin_step_flops_by_hand():
    counts = load_module(BENCH, "counts", "gin_signnet_zinc")
    cfg = config("gin_signnet_zinc", n_layers=1, hidden_dim=4, out_dim=4,
                 pos_enc_dim=1, sign_inv_layers=2, phi_out_dim=1)
    real = {"nodes": 3, "edges": 4, "graphs": 1}
    mm, agg = costs.signnet(real, 1, 4, 1, 2)
    mm2, agg2 = costs.embed_and_readout(real, 1, 4, 4)
    layer_mm, layer_agg = 2 * 3 * 16 * 2, 4 * 4
    want = costs.train_flops(mm + mm2 + layer_mm, agg + agg2 + layer_agg, 9)
    assert counts.step_flops(cfg, real, 9) == want


def test_k1_bytes_by_hand():
    # 3 real nodes reached, 8 slots, 4 counted edges, 2 features
    real = {"nodes": 3, "edges": 4, "graphs": 1}
    fwd = 4 * 2 * (3 + 8) + 4 * 9 + 8 * 4
    assert costs.k1_bound_s(2, False, (8, 16, 2), real) == pytest.approx(
        fwd / costs.PEAK_BYTES)
    bwd = fwd + 4 * 4
    assert costs.k1_bound_s(2, True, (8, 16, 2), real) == pytest.approx(
        bwd / costs.PEAK_BYTES)


def test_k4_bytes_by_hand():
    real = {"nodes": 3, "edges": 4, "graphs": 1}
    # Bh, Dh, Eh at 3 rows; Ce at 4 edges; agg at 8 slots; e_new at 16
    want = 4 * 2 * (3 * 3 + 4 + 8 + 16) + 4 * 9 + 8 * 4
    assert costs.k4_bound_s(2, (8, 16, 2), real) == pytest.approx(
        want / costs.PEAK_BYTES)


@pytest.mark.parametrize("name", ["gin_signnet_zinc", "gatedgcn_signnet_zinc"])
def test_kernel_schedule_is_the_programs(name, monkeypatch):
    """One eager train step of the configuration at a tiny width on the
    CPU: the tile-local SpMM's and the gate's plain versions are called
    with the features and directions the counts list, launch by launch."""
    from harness.cell import first_batches, make_inputs
    from harness.program import Program
    from harness.spec import Cell
    import importlib
    spmm_tiled = importlib.import_module(
        "signnet_basisnet_tpu_torch.ops.spmm_tiled")
    gatedgcn_gate = importlib.import_module(
        "signnet_basisnet_tpu_torch.ops.gatedgcn_gate")
    counts = load_module(BENCH, "counts", name)
    cfg = config(name, n_layers=2, hidden_dim=6, out_dim=6,
                 sign_inv_layers=3)
    cfg["name"] = name
    traffic = {"molecules": 40, "batch_graphs": 8, "prefetch": 2,
               "dataset_seed": 3}
    cell = Cell(name="t", chips=1, config=cfg, traffic=traffic, limits={},
                end_to_end=[], per_layer=[], bench_dir=BENCH)
    graphs, params, buffers = make_inputs(cell, 5, torch.device("cpu"))
    program = Program(cfg, traffic, graphs, 5, torch.device("cpu"), params,
                      buffers)
    batch = first_batches(program, 1)[0]
    program.make_step(batch)
    k1, k4 = [], []
    plain_k1, plain_k4 = spmm_tiled.spmm_tiled_plain, \
        gatedgcn_gate.gatedgcn_gate_plain

    def spy_k1(x, senders, receivers, weights, starts, ends, bn,
               transpose=False):
        k1.append((x.shape[1], bool(transpose)))
        return plain_k1(x, senders, receivers, weights, starts, ends, bn,
                        transpose)

    def spy_k4(Bh, *a, **kw):
        k4.append(Bh.shape[1])
        return plain_k4(Bh, *a, **kw)

    monkeypatch.setattr(spmm_tiled, "spmm_tiled_plain", spy_k1)
    monkeypatch.setattr(gatedgcn_gate, "gatedgcn_gate_plain", spy_k4)
    program.step(batch, program.lr)
    assert sorted(k1) == sorted(counts.k1_launches(cfg))
    assert sorted(k4) == sorted(counts.k4_launches(cfg))
