"""Dense mode: batches of per-graph blocks (`graph/dense.py`), the dense
branches of the GIN family, `pool_any` and the ZINC nets' embedding, the
batched masked eigh and the dense Laplacians, against the JAX package and
against the port's own flat path.

`dense_batch_np` reserves no padding graph and `batch_np` does, so dense
against flat compares the real graphs (slots 0-2, as JAX
tests/test_dense_mode.py does); the layouts are sized so that both hold
14 padding rows, which the SignNet rho's BatchNorm (no mask) counts in
both.  `torch.linalg.eigh` and `jnp.linalg.eigh` may pick other bases of
a repeated eigenvalue, so eigenvectors are held through L v = lambda v
and the eigenspace projectors, and `canonical_sign` on simple spectra.

Tolerances, float32: the packer's arrays exactly; a layer or net forward
2e-4 dense against flat (JAX's own bar) and 1e-5 against JAX's dense
forward; gradients 1e-4 relative plus 1e-6 of the net's largest;
eigenvalues 1e-5, L v = lambda v 1e-4, projectors 1e-4.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from signnet_basisnet_tpu import models as JM
from signnet_basisnet_tpu import spectral as jsp
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.graph.dense import dense_batch_np as jdense_batch_np
from signnet_basisnet_tpu.graph.dense import \
    dense_from_arrays as jdense_from_arrays
from signnet_basisnet_tpu.graph.dense import dense_neighbor_sum as jdense_sum
from signnet_basisnet_tpu.graph.dense import dense_pool as jdense_pool
from signnet_basisnet_tpu.spectral import laplacian as jlap

from signnet_basisnet_tpu_torch import bench
from signnet_basisnet_tpu_torch import models as TM
from signnet_basisnet_tpu_torch import spectral as tsp
from signnet_basisnet_tpu_torch.bridge import load_flax_variables, torch_name
from signnet_basisnet_tpu_torch.graph import (DenseGraphBatch, batch_np,
                                              dense_batch_np,
                                              dense_from_arrays,
                                              dense_neighbor_sum, dense_pool,
                                              from_arrays)
from signnet_basisnet_tpu_torch.models import conv as tconv
from signnet_basisnet_tpu_torch.nn import ElementsMLP, Embedding
from signnet_basisnet_tpu_torch.nn.init import init_parameters

from test_torch_pe import _flat, _port_view


def graphs(seed, sizes=(5, 7, 6), k=4):
    """JAX tests/test_dense_mode.py's random graphs, with k-column LapPE
    plus N(0, 1e-2) noise: exact eigenvectors put the phi's first layer
    on ReLU's kink, where a gradient of 0 in exact arithmetic takes float
    noise's sign (tests/test_torch_alchemy.py does the same)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        A = np.triu((rng.random((n, n)) < 0.5).astype(int), 1)
        A = A + A.T
        s, r = np.nonzero(A)
        vals, vecs = tsp.lap_pe_np(s, r, n, k=k)
        vecs = (vecs + rng.normal(scale=1e-2, size=vecs.shape)).astype(
            np.float32)
        out.append(dict(senders=s, receivers=r,
                        node_feat=rng.integers(0, 28, n),
                        edge_feat=rng.integers(0, 4, len(s)),
                        y=np.array([float(rng.normal())], np.float32),
                        eigvals=vals, eigvecs=vecs))
    return out


def both(seed):
    """(flat arrays, dense arrays) of the same three graphs: 32 node slots
    flat, 4 x 8 dense, 14 padding rows each."""
    gs = graphs(seed)
    return (batch_np(gs, 32, 96, 5, k=4),
            dense_batch_np(gs, num_graphs=4, max_nodes=8, k=4))


def to_dense_rows(x_flat, n_node, num_graphs=4, max_nodes=8):
    """Flat rows (graphs contiguous from 0) into [G, M, ...] blocks."""
    out = np.zeros((num_graphs, max_nodes) + x_flat.shape[1:], x_flat.dtype)
    off = 0
    for g in range(num_graphs):
        n = int(n_node[g])
        out[g, :n] = x_flat[off:off + n]
        off += n
    return out


@pytest.mark.parametrize("k", [None, 3, 6])
def test_dense_batch_np_matches_jax(k):
    gs = graphs(0)
    a = dense_batch_np(gs, 5, 9, k=k)
    b = jdense_batch_np(gs, 5, 9, k=k)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    with pytest.raises(ValueError, match="exceeds max_nodes"):
        dense_batch_np(gs, 5, 6)
    gb = dense_from_arrays(a)
    assert isinstance(gb, DenseGraphBatch)
    assert (gb.num_graphs, gb.max_nodes) == (5, 9)
    np.testing.assert_array_equal(gb.in_degrees().numpy(),
                                  a["adj"].sum(-1))
    np.testing.assert_allclose(gb.snorm()[..., 0].numpy(),
                               a["node_mask"] / np.sqrt(
                                   np.maximum(a["n_node"], 1))[:, None])


@pytest.mark.parametrize("shape", [(6,), (3, 6)])
def test_dense_neighbor_sum_matches_flat_and_jax(shape):
    """adj @ x against the flat masked segment sum (JAX
    tests/test_dense_mode.py:40) and JAX's einsum, 3-D and 4-D."""
    flat, dense = both(0)
    r = np.random.default_rng(1)
    x_flat = (r.normal(size=(32,) + shape)
              * flat["node_mask"].reshape((-1,) + (1,) * len(shape))
              ).astype(np.float32)
    x_dense = to_dense_rows(x_flat, dense["n_node"])
    got = dense_neighbor_sum(torch.from_numpy(dense["adj"]),
                             torch.from_numpy(x_dense)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jdense_sum(jnp.asarray(dense["adj"]),
                                   jnp.asarray(x_dense))), rtol=1e-6,
        atol=1e-6)
    agg_flat = tconv.neighbor_sum(torch.from_numpy(x_flat),
                                  from_arrays(flat)).numpy()
    np.testing.assert_allclose(got, to_dense_rows(agg_flat, dense["n_node"]),
                               atol=1e-5)
    with pytest.raises(ValueError, match="unsupported rank"):
        dense_neighbor_sum(torch.zeros(4, 8, 8), torch.zeros(4, 8))


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_dense_pool_matches_jax(reduce):
    _, dense = both(1)
    x = np.random.default_rng(2).normal(size=(4, 8, 3, 5)).astype(np.float32)
    np.testing.assert_allclose(
        dense_pool(torch.from_numpy(x), torch.from_numpy(dense["node_mask"]),
                   reduce).numpy(),
        np.asarray(jdense_pool(jnp.asarray(x),
                               jnp.asarray(dense["node_mask"]), reduce)),
        rtol=1e-6, atol=1e-6)


NET = dict(hidden_dim=16, out_dim=16, n_layers=3, pos_enc_dim=4,
           lap_method="sign_inv", sign_inv_layers=2, phi_out_dim=2,
           batch_norm=True, dropout=0.0)


@pytest.mark.parametrize("phi", ["gin", "masked_gin"])
def test_gin_net_dense_matches_flat_and_jax(phi, monkeypatch):
    """Same weights, training mode: the dense scores and every gradient
    equal JAX's dense forward's; no kernel wrapper runs on a dense batch.
    With the GIN phi the dense scores of the three real graphs also equal
    the flat ones (JAX tests/test_dense_mode.py:66), and so do the BN
    running statistics after the forward (the masked BN over [G, M, ...]
    with a [G, M] mask).  The masked phi's k-mask at a padding row is its
    graph's size in the dense layout and 1 in the flat one, and its rho's
    BN counts every row, so there dense and flat part in JAX too (by the
    same 8e-3 here): only JAX's dense forward holds it."""
    flat, dense = both(1)
    net = dict(NET, sign_inv_net=phi)
    jm = JM.GINNet(**net)
    jflat = jfrom_arrays(flat)
    jdense = jdense_from_arrays(dense)
    variables = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(0)}, jflat, jflat.eigvecs,
        training=False))
    c = np.random.default_rng(3).normal(size=4).astype(np.float32)

    def loss(params):
        out, upd = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            jdense, jdense.eigvecs, training=True,
                            mutable=["batch_stats"])
        return (out * c).sum(), (out, upd)

    (_, (jout, upd)), jg = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])

    def port():
        tm = TM.GINNet(**net)
        load_flax_variables(tm, variables)
        return tm

    tflat, tdense = from_arrays(flat), dense_from_arrays(dense)
    m_flat, m_dense = port(), port()
    out_flat = m_flat(tflat, tflat.eigvecs)
    monkeypatch.setattr(tconv, "spmm_tiled", None)   # never reached
    out_dense = m_dense(tdense, tdense.eigvecs)
    (out_dense * torch.from_numpy(c)).sum().backward()
    if phi == "gin":
        np.testing.assert_allclose(out_dense.detach().numpy()[:3],
                                   out_flat.detach().numpy()[:3], atol=2e-4)
        for (n, a), (_, b) in zip(m_dense.named_buffers(),
                                  m_flat.named_buffers()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=n)
    np.testing.assert_allclose(out_dense.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    grads = _flat(jg)
    top = max(np.abs(g).max() for g in grads.values())
    params = dict(m_dense.named_parameters())
    for path, g in grads.items():
        name = torch_name(path)
        got = params[name].grad
        got = torch.zeros_like(params[name]) if got is None else got
        np.testing.assert_allclose(got.numpy(), _port_view(path, g),
                                   rtol=1e-4, atol=1e-6 * top, err_msg=name)
    buffers = dict(m_dense.named_buffers())
    for path, s in _flat(upd["batch_stats"]).items():
        np.testing.assert_allclose(buffers[torch_name(path)].numpy(), s,
                                   rtol=1e-5, atol=1e-5)


def test_gine_convs_dense_match_flat_and_jax():
    """GINEConv over [G, M(dst), M(src), D] edge features against its flat
    self (JAX tests/test_dense_mode.py:87); MaskedGINEConv's dense branch,
    3-D and 4-D, against JAX's."""
    flat, dense = both(2)
    tflat, tdense = from_arrays(flat), dense_from_arrays(dense)
    gen = torch.Generator().manual_seed(0)
    emb, eemb = Embedding(28, 8), Embedding(4, 8)
    conv = tconv.GINEConv(ElementsMLP(8, 8, num_layers=2,
                                      with_final_activation=False))
    for m in (emb, eemb, conv):
        init_parameters(m, gen)
    with torch.no_grad():
        conv.eps.fill_(0.3)

    def run(gb):
        x = emb(gb.node_feat)
        return tconv.pool_any(gb, conv(gb, x, eemb(gb.edge_feat)))

    np.testing.assert_allclose(run(tdense).detach().numpy()[:3],
                               run(tflat).detach().numpy()[:3], atol=2e-4)

    jdense = jdense_from_arrays(dense)
    r = np.random.default_rng(4)
    e = r.normal(size=(4, 8, 8, 6)).astype(np.float32)
    for shape in ((4, 8, 6), (4, 8, 3, 6)):
        x = r.normal(size=shape).astype(np.float32)
        mask = np.broadcast_to(dense["node_mask"].reshape(
            (4, 8) + (1,) * (len(shape) - 3)), shape[:-1]).astype(np.float32)
        jc = JM.MaskedGINEConv(5)
        v = jax.tree.map(np.asarray, jc.init(
            jax.random.PRNGKey(1), jdense, jnp.asarray(x), jnp.asarray(e),
            mask=jnp.asarray(mask), training=False))
        v["params"]["eps"] = np.float32(0.2)
        want, _ = jc.apply(v, jdense, jnp.asarray(x), jnp.asarray(e),
                           mask=jnp.asarray(mask), training=True,
                           mutable=["batch_stats"])
        tc = tconv.MaskedGINEConv(6, 5)
        load_flax_variables(tc, v)
        got = tc(tdense, torch.from_numpy(x), torch.from_numpy(e),
                 mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_layers_without_a_jax_dense_branch_refuse_a_dense_batch():
    """GCN, GAT, GatedGCN (and its LSPE layer), PNA (towers and none),
    the simplified PNA, the Transformer and NetGINE's conv have no dense
    branch in the JAX package, which fails on `gb.senders` there: the
    port's raise TypeError and say so."""
    _, dense = both(0)
    gb = dense_from_arrays(dense)
    x = torch.zeros(4, 8, 8)
    pna = dict(aggregators=("mean",), scalers=("identity",), avg_d_log=1.0)
    for layer, args in (
            (tconv.GCNConv(8, 8), (x,)),
            (tconv.GATConv(8, 8), (x,)),
            (tconv.GatedGCNLayer(8, 8), (x, x)),
            (tconv.GatedGCNLSPELayer(8, 8), (x, x, x)),
            (tconv.PNALayer(8, 8, 8, **pna), (x, x)),
            (tconv.PNANoTowersLayer(8, 8, 8, **pna), (x, x)),
            (tconv.SimplifiedPNAConv(8, 8), (x,)),
            (tconv.GraphTransformerLayer(8, 2), (x, x)),
            (TM.GINEBondConv(8, 4), (x, x))):
        with pytest.raises(TypeError, match="no dense-batch branch"):
            layer(gb, *args)
    with pytest.raises(AttributeError, match="senders"):
        JM.GCNConv(8).init(jax.random.PRNGKey(0), jdense_from_arrays(dense),
                           jnp.zeros((4, 8, 8)))


def _laplacians(seed=0, sizes=(5, 8, 12), npad=12):
    """Padded sym-normalised Laplacians of random graphs, f32, and masks."""
    rng = np.random.default_rng(seed)
    Ls = np.zeros((len(sizes), npad, npad), np.float32)
    mask = np.zeros((len(sizes), npad), np.float32)
    for i, n in enumerate(sizes):
        A = np.triu((rng.random((n, n)) < 0.4).astype(float), 1)
        Ls[i, :n, :n] = tsp.sym_laplacian_np(A + A.T)
        mask[i, :n] = 1
    return Ls, mask


def _projectors(vals, vecs, n, tol=1e-4):
    """The eigenspace projectors of the first n pairs, by groups of
    eigenvalues within tol."""
    out, start = [], 0
    for j in range(1, n + 1):
        if j == n or vals[j] - vals[j - 1] > tol:
            V = vecs[:, start:j].astype(np.float64)
            out.append(V @ V.T)
            start = j
    return out


def test_masked_eigh_matches_numpy_and_jax():
    """Batched masked eigh of padded Laplacians (JAX
    tests/test_spectral.py:35): each graph's spectrum as numpy's, JAX's
    eigenvalues and eigenspace projectors, L v = lambda v on the real
    block, the padding pairs and rows zero."""
    Ls, mask = _laplacians()
    vals, vecs, valid = (t.numpy() for t in tsp.batched_masked_eigh(
        torch.from_numpy(Ls), torch.from_numpy(mask)))
    jvals, jvecs, jvalid = (np.asarray(t) for t in jsp.batched_masked_eigh(
        jnp.asarray(Ls), jnp.asarray(mask)))
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(vals, jvals, atol=1e-5)
    for i, n in enumerate(mask.sum(1).astype(int)):
        np.testing.assert_allclose(vals[i, :n],
                                   np.linalg.eigh(Ls[i, :n, :n])[0],
                                   atol=1e-5)
        assert (vals[i, n:] == 0).all() and (vecs[i, :, n:] == 0).all()
        assert (vecs[i, n:, :] == 0).all()
        lv = Ls[i, :n, :n] @ vecs[i, :n, :n]
        np.testing.assert_allclose(lv, vecs[i, :n, :n] * vals[i, None, :n],
                                   atol=1e-4)
        for a, b in zip(_projectors(vals[i], vecs[i], n),
                        _projectors(jvals[i], jvecs[i], n)):
            np.testing.assert_allclose(a, b, atol=1e-4)
    assert tsp.PAD_EIGVAL == jsp.PAD_EIGVAL


def test_canonical_sign_matches_jax():
    """On columns with one entry of largest magnitude: JAX's signs, and the
    same result from any sign flips (JAX tests/test_spectral.py:101)."""
    V = np.random.default_rng(3).normal(size=(2, 7, 4)).astype(np.float32)
    flips = np.array([1, -1, 1, -1], np.float32)
    a = tsp.canonical_sign(torch.from_numpy(V)).numpy()
    np.testing.assert_array_equal(a, np.asarray(jsp.canonical_sign(
        jnp.asarray(V))))
    np.testing.assert_array_equal(
        tsp.canonical_sign(torch.from_numpy(V * flips)).numpy(), a)


@pytest.mark.parametrize("masked", [True, False])
def test_dense_laplacians_match_jax(masked):
    """sym_laplacian_dense (the identity masked at padding slots or not),
    unnormalized_laplacian_dense and dense_adjacency_from_graph, the last
    over a padded flat batch's edges."""
    flat, dense = both(5)
    A, m = dense["adj"], dense["node_mask"]
    tm = torch.from_numpy(m) if masked else None
    jm = jnp.asarray(m) if masked else None
    np.testing.assert_allclose(
        tsp.sym_laplacian_dense(torch.from_numpy(A), tm).numpy(),
        np.asarray(jlap.sym_laplacian_dense(jnp.asarray(A), jm)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tsp.unnormalized_laplacian_dense(torch.from_numpy(A)).numpy(),
        np.asarray(jlap.unnormalized_laplacian_dense(jnp.asarray(A))))
    gb = from_arrays(flat)
    emask = gb.edge_mask if masked else None
    np.testing.assert_array_equal(
        tsp.dense_adjacency_from_graph(gb.senders, gb.receivers, 32,
                                       emask).numpy(),
        np.asarray(jlap.dense_adjacency_from_graph(
            jnp.asarray(flat["senders"]), jnp.asarray(flat["receivers"]), 32,
            None if emask is None else jnp.asarray(flat["edge_mask"]))))


def test_bench_dense_step_runs_on_the_cpu():
    """`bench --mode dense`'s step at a small size: the dense batches of
    `build_dense_batches`, eager steps, edges counted from the
    adjacency."""
    batches = bench.build_dense_batches(num_batches=2, batch_graphs=8, k=4)
    assert batches[0]["adj"].shape == (8, bench.DENSE_MAX_NODES,
                                       bench.DENSE_MAX_NODES)
    net = dict(bench.NET, hidden_dim=8, out_dim=8, n_layers=2, pos_enc_dim=4,
               sign_inv_layers=2)
    out = bench.bench_dense(batches, "cpu", net=net, steps=2, warmup=1)
    assert out["edges_per_s"] > 0 and out["step_ms"] > 0
    edges = sum(b["adj"].sum() for b in batches)
    assert out["edges_per_s"] * out["step_ms"] * 2 / 1e3 == \
        pytest.approx(edges)
