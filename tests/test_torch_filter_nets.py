"""The nine spectral-filter nets of the port (`FILTER_MODEL_REGISTRY`)
against the JAX package's, under bridged parameters, on a 6x6 grid: each
net's forward and gradients (`module_parity` of tests/test_torch_ign.py:
outputs 1e-5 in f32, gradients 1e-7 relative in f64 with JAX under x64,
the port's f32 gradients within 1e-4 relative plus twice JAX's f32 error
of its f64 ones), `gcn_norm_weights` and `propagate` (1e-6 and 1e-5), and
the nets' own inits.  No kernel lies on this path in either package:
`propagate` is a gather and a segment sum (XLA in JAX), `TransformerNet`'s
attention dense einsums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signnet_basisnet_tpu.models import spectral_filters as JSF

from signnet_basisnet_tpu_torch import train_filters as TF
from signnet_basisnet_tpu_torch.models import spectral_filters as TSF
from signnet_basisnet_tpu_torch.training import count_params

from test_torch_filters import N, _dt, jgb, tgb
from test_torch_ign import TOL, module_parity
from test_torch_pe import _flat


# ---------------------------------------------------------------- nets

@pytest.mark.parametrize("name", list(JSF.FILTER_MODEL_REGISTRY))
def test_filter_net_matches_jax(name):
    """Each registry net's forward and gradients, on a 3-feature input."""
    x = np.random.default_rng(1).normal(size=(N, 3))
    jm = JSF.FILTER_MODEL_REGISTRY[name](hidden=8, num_layers=2)
    tm = TSF.FILTER_MODEL_REGISTRY[name](3, hidden=8, num_layers=2)
    out, var = module_parity(
        jm, lambda dt: (jgb(dt), jnp.asarray(x.astype(dt))), tm,
        lambda dt: (tgb(_dt(dt)), torch.from_numpy(x).to(_dt(dt))))
    assert out.shape == (N, 1)
    assert count_params(tm) == sum(a.size for a in
                                   _flat(var["params"]).values())


def test_gcn_norm_weights_and_propagate_match_jax():
    x = np.random.default_rng(2).normal(size=(N, 4)).astype(np.float32)
    for loops in (True, False):
        jw, jsw = JSF.gcn_norm_weights(jgb(np.float32), loops)
        tw, tsw = TSF.gcn_norm_weights(tgb(torch.float32), loops)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
        assert (tsw is None) == (jsw is None)
        want = JSF.propagate(jgb(np.float32), jnp.asarray(x), jw, jsw)
        got = TSF.propagate(tgb(torch.float32), torch.from_numpy(x), tw, tsw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_filter_net_inits():
    """GPRNet's temp is L1-normalised; the attention projections are
    uniform within sqrt(1.5 / d) with zero biases; BernNet's coe is 1."""
    g = TSF.GPRNet(3, hidden=8)
    TF.init_parameters(g, torch.Generator().manual_seed(0))
    assert abs(float(g.temp.detach().abs().sum()) - 1.0) < 1e-6
    t = TSF.TransformerNet(3, hidden=16)
    TF.init_parameters(t, torch.Generator().manual_seed(0))
    for name in ("query", "key", "value", "out"):
        lin = getattr(t.attn_0, name)
        assert float(lin.weight.detach().abs().max()) <= np.sqrt(1.5 / 16)
        assert not lin.bias.any()
    assert (TSF.BernNet(3).coe.detach() == 1).all()
