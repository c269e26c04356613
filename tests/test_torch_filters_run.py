"""The LearningFilters entry point of the port against the JAX package: Adam
steps of `train_filters`' train step, the 2D-grid loader and the labels of
all six filters, the eigenbasis re-draw of `--basis_rot_seed`,
`train_filters.run` end to end (its log lines and CSV
row letter for letter the JAX train_filters', the epoch-block check), the
vmapped run against the serial one, the three published rows' parameter
counts on the real grid, and `train_filters`' refusals.  The model parity is
in tests/test_torch_filters.py.

Every run reads a copy of a grid's .mat under the test's temporary
directory and writes its eigenpair and label caches there, never into
data/2dgrid/.  The tiny grid is 8x8 with 3 random images.

Tolerances: Adam steps as stated in `test_adam_steps_match_jax`; the
loader's arrays, eigenpairs and labels bit for bit (the same numpy
calls); the vmapped trainer as stated in `test_vmapped_matches_serial`
(f64 steps within 1e-6; batched matmuls sum in another order).
"""
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from signnet_basisnet_tpu import train_filters as JF
from signnet_basisnet_tpu.data import twodgrid as jgrid
from signnet_basisnet_tpu.training import adam as jadam
from signnet_basisnet_tpu.training import metrics as JMET
from signnet_basisnet_tpu.training import scale_updates

from signnet_basisnet_tpu_torch import train_filters as TF
from signnet_basisnet_tpu_torch.bridge import (load_flax_variables,
                                               port_value, torch_name)
from signnet_basisnet_tpu_torch.data import twodgrid as tgrid
from signnet_basisnet_tpu_torch.spectral import eigenspace_layout
from signnet_basisnet_tpu_torch.training import adam, count_params, set_lr

from test_torch_filters import N, _dt, fm_kwargs, inputs, jgb, models, tgb
from test_torch_pe import _flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL_MAT = os.path.join(ROOT, "data", "2dgrid", "2Dgrid.mat")
quiet = lambda *a, **k: None


# ---------------------------------------------------------------- steps

def _jax_steps(jm, var, jargs, jkw, y, mask, lr, steps):
    """The JAX train step (train_filters._run's `train_step`),
    rebuilt from FilterModel, adam and scale_updates: losses, r2 and
    parameters after each step."""
    tx = jadam()

    def step(params, bs, opt_state):
        def loss_fn(p):
            pred, upd = jm.apply({"params": p, "batch_stats": bs}, *jargs,
                                 training=True, mutable=["batch_stats"],
                                 **jkw)
            return JMET.masked_mse_sum(pred, y, mask), (
                pred, upd.get("batch_stats", bs))
        (loss, (pred, nbs)), g = jax.value_and_grad(loss_fn,
                                                    has_aux=True)(params)
        upds, opt = tx.update(g, opt_state, params)
        upds = scale_updates(upds, lr)
        params = jax.tree.map(lambda a, b: a + b, params, upds)
        return params, nbs, opt, loss, JMET.masked_r2(pred, y, mask)

    jstep = jax.jit(step)
    params = var["params"]
    bs = var.get("batch_stats", {})
    opt = tx.init(params)
    out = []
    for _ in range(steps):
        params, bs, opt, loss, r2 = jstep(params, bs, opt)
        out.append((float(loss), float(r2),
                    jax.tree.map(np.asarray, params)))
    return out


@pytest.mark.parametrize("lap_method", ["basis_inv", "sign_inv"])
def test_adam_steps_match_jax(lap_method):
    """Three steps of `train_filters.train_step` (basis_inv; sign_inv with
    the DS phi), from bridged weights: the f32 step's loss and r2, the f64
    steps' losses, r2 and parameters (see the module docstring)."""
    inp = inputs()
    jm, tm = models(inp, "DS", lap_method)
    kw = fm_kwargs(inp, lap_method)
    x = inp["x"]
    y = (np.random.default_rng(3).random((N, 1))).astype(np.float32)
    mask = np.ones((N, 1), np.float32)
    mask[0] = 0.0
    var = jax.tree.map(np.asarray, jax.jit(lambda key: jm.init(
        {"params": key}, jgb(np.float32), jnp.asarray(x), training=False,
        **kw(np.float32, True)))(jax.random.PRNGKey(1)))
    lr = 0.01
    for dt, loss_tol, param_tol in ((np.float32, 1e-5, None),
                                    (np.float64, 1e-6, 1e-9)):
        with jax.enable_x64(dt == np.float64):
            cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dt), t)
            want = _jax_steps(jm, cast(var), (jgb(dt), jnp.asarray(
                x.astype(dt))), kw(dt, True), jnp.asarray(y.astype(dt)),
                jnp.asarray(mask.astype(dt)), lr, 3)
        model = models(inp, "DS", lap_method)[1]
        load_flax_variables(model, var)
        model = model.to(_dt(dt)).train()
        opt = adam(model.parameters())
        set_lr(opt, lr)
        tdt = _dt(dt)
        ty, tmask = torch.from_numpy(y).to(tdt), torch.from_numpy(mask).to(tdt)
        for s, (wloss, wr2, wparams) in enumerate(want):
            loss, r2 = TF.train_step(model, opt, tgb(tdt),
                                     torch.from_numpy(x).to(tdt), ty, tmask,
                                     kw(tdt, False))
            r2 = float(r2)
            np.testing.assert_allclose(float(loss), wloss, rtol=loss_tol)
            np.testing.assert_allclose(r2, wr2, rtol=loss_tol,
                                       atol=loss_tol)
            if param_tol is None:
                break       # f32: the first step's loss and r2 only
            params = dict(model.named_parameters())
            for path, w in _flat(wparams).items():
                np.testing.assert_allclose(
                    params[torch_name(path)].detach().numpy(),
                    port_value(path, w), rtol=param_tol, atol=1e-3 * lr,
                    err_msg=f"step {s + 1} {torch_name(path)}")



# ---------------------------------------------------------------- data

def tiny_mat(path, side=8, images=3, seed=0):
    """A side x side grid .mat in the 2Dgrid.mat layout (A, F, mask)."""
    n = side * side
    A = np.zeros((n, n), np.uint8)
    for i in range(side):
        for j in range(side):
            u = i * side + j
            if j + 1 < side:
                A[u, u + 1] = A[u + 1, u] = 1
            if i + 1 < side:
                A[u, u + side] = A[u + side, u] = 1
    r = np.random.default_rng(seed)
    mask = np.ones((n, 1), np.uint8)
    mask[:3] = 0
    sio.savemat(path, dict(A=A, F=r.random((n, images)), mask=mask))
    return path


def test_load_twodgrid_and_labels_match_jax(tmp_path):
    """The arrays, the eigenpairs (computed by one package, read back from
    the cache by the other) and the labels of every filter, bit for bit."""
    mat = tiny_mat(str(tmp_path / "grid.mat"))
    t = tgrid.load_twodgrid(mat)
    assert os.path.exists(tmp_path / "eigenvalues.npy")
    j = jgrid.load_twodgrid(mat)                 # from the port's cache
    os.remove(tmp_path / "eigenvalues.npy")
    j_fresh = jgrid.load_twodgrid(mat)           # computed by JAX's
    for key in ("senders", "receivers", "x", "mask", "eigvals", "eigvecs"):
        for other in (j, j_fresh):
            assert t[key].dtype == other[key].dtype, key
            np.testing.assert_array_equal(t[key], other[key], err_msg=key)
    assert t["n"] == j["n"] == 64
    assert tgrid.FILTERS == jgrid.FILTERS
    lam = np.linspace(0.0, 2.0, 41)
    for f in tgrid.FILTERS:
        np.testing.assert_array_equal(tgrid.filter_response(f, lam),
                                      jgrid.filter_response(f, lam))
        y = tgrid.filter_labels(t, f, cache_dir=str(tmp_path))
        assert y.dtype == np.float32 and y.shape == (64, 3)
        np.testing.assert_array_equal(y, jgrid.filter_labels(j, f))
        np.testing.assert_array_equal(      # read back from the cache
            jgrid.filter_labels(j, f, cache_dir=str(tmp_path)), y)
    with pytest.raises(ValueError):
        tgrid.filter_response("notch", lam)


def test_rotate_within_eigenspaces_matches_jax(tmp_path):
    """`--basis_rot_seed`'s re-draw of the basis inside every repeated
    eigenspace, bit for bit (the same numpy calls): the spectrum is kept
    (V diag(lambda) V^T unchanged) and the columns stay orthonormal."""
    t = tgrid.load_twodgrid(tiny_mat(str(tmp_path / "grid.mat")))
    V, w = t["eigvecs"], t["eigvals"]
    got = TF._rotate_within_eigenspaces(V, w, 3)
    np.testing.assert_array_equal(got, JF._rotate_within_eigenspaces(V, w, 3))
    assert not np.array_equal(got, V)
    np.testing.assert_allclose(got.T @ got, np.eye(64), atol=1e-5)
    np.testing.assert_allclose((got * w) @ got.T, (V * w) @ V.T, atol=1e-5)


# ---------------------------------------------------------------- run

def _args(module, tmp_path, *argv):
    return module.build_parser().parse_args([
        "--mat_path", str(tmp_path / "grid.mat"), "--label_dir",
        str(tmp_path), *argv] + (["--device", "cpu"] if module is TF
                                 else []))


def _template(line):
    """A log or CSV line with every number replaced by #."""
    return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", line)


@pytest.mark.parametrize("argv", [
    ["--net", "DS", "--use_eig", "--lap_method", "basis_inv",
     "--ign_hidden", "8"],
    ["--net", "GcnNet"]])
def test_run_logs_and_csv_as_the_jax_entry_point(tmp_path, argv):
    """Both packages' `train_filters` on the tiny grid: the same log lines and CSV row but
    for the numbers (the PARAMETERS line's number too), and the loss falls
    from the first epoch's to the run's best."""
    tiny_mat(str(tmp_path / "grid.mat"))
    common = ["--hidden_channels", "8", "--epochs", "20", "--scan_epochs",
              "10", "--img_num", "2"] + argv
    logs = {}
    for module in (JF, TF):
        logs[module] = []
        out = tmp_path / module.__name__.split(".")[0]
        module.run(_args(module, tmp_path, *common, "--results_dir",
                         str(out)), log=logs[module].append)
        with open(out / "band_2.csv") as f:
            logs[module].append(f.read().strip())
    jl, tl = logs[JF], logs[TF]
    assert [_template(l) for l in tl] == [_template(l) for l in jl]
    assert [l for l in tl if l.startswith("PARAMETERS")] == \
        [l for l in jl if l.startswith("PARAMETERS")]
    row = tl[-1].split(",")
    assert len(row) == 7 and row[0] == argv[1]
    assert row[3:] == jl[-1].split(",")[3:]
    first = TF.run(_args(TF, tmp_path, *common[:2], "--epochs", "1",
                         "--scan_epochs", "1", "--img_num", "2",
                         "--results_dir", "", *argv), log=quiet)
    best = np.array([float(re.search(r"loss=([0-9.]+)", l).group(1))
                     for l in tl if re.match(r"img \d+: ", l)])
    assert (best < first[:, 0]).all(), (best, first)


def test_run_refuses_epochs_off_the_block(tmp_path):
    tiny_mat(str(tmp_path / "grid.mat"))
    args = _args(TF, tmp_path, "--epochs", "5", "--scan_epochs", "2",
                 "--results_dir", "")
    with pytest.raises(ValueError, match="multiple of --scan_epochs"):
        TF.run(args, log=quiet)


def test_train_filters_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny_mat(str(tmp_path / "grid.mat"))
    args = TF.build_parser().parse_args([
        "--mat_path", str(tmp_path / "grid.mat"), "--epochs", "2",
        "--scan_epochs", "2"])
    assert args.device == "cuda" and args.results_dir == os.path.join(
        "out", "filters")
    with pytest.raises(RuntimeError, match="--device cpu"):
        TF.run(args, log=quiet)


def test_run_imports_no_jax(tmp_path):
    """`train_filters` runs with jax unimportable (the tiny grid, SignNet PE
    with the MLP phi, k = 8)."""
    tiny_mat(str(tmp_path / "grid.mat"))
    code = f"""
import sys
sys.modules["jax"] = None
from signnet_basisnet_tpu_torch import train_filters as t
t.run(t.build_parser().parse_args([
    "--device", "cpu", "--net", "DS", "--use_eig", "--lap_method",
    "sign_inv", "--sign_inv_net", "MLP", "--k", "8", "--epochs", "4",
    "--scan_epochs", "2", "--img_num", "1", "--results_dir", "",
    "--mat_path", {str(tmp_path / "grid.mat")!r},
    "--label_dir", {str(tmp_path)!r}]))
assert not [m for m, mod in sys.modules.items() if mod is not None and (
            m.split(".")[0] in ("jax", "jaxlib", "flax")
            or m.startswith("signnet_basisnet_tpu."))]
"""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "mean loss=" in proc.stdout


# ---------------------------------------------------------------- real grid

@pytest.fixture(scope="module")
def real_grid(tmp_path_factory):
    """A copy of the real 2Dgrid.mat, its eigenpairs cached beside it."""
    d = tmp_path_factory.mktemp("grid")
    shutil.copy(REAL_MAT, d / "grid.mat")
    return d, tgrid.load_twodgrid(str(d / "grid.mat"))


def test_published_parameter_counts(real_grid):
    """The three published rows' PARAMETERS on the real grid (n = 1024, all
    eigenvectors), as in the JAX logs (results/r2/band50_*.log), from the
    layout alone: no projector stack is built."""
    _, data = real_grid
    lay = eigenspace_layout(data["eigvals"])
    assert lay.uniq_mults == [1, 2, 32] and lay.num_spaces == 513
    rows = {
        48732: dict(net="DS", hidden=32, num_layers=3,
                    lap_method="sign_inv"),
        48331: dict(net="Transformer", hidden=16, lap_method="sign_inv"),
        48221: dict(net="DS", hidden=16, lap_method="basis_inv",
                    ign_hidden=16, mult_list=tuple(lay.uniq_mults),
                    spaces_per_mult=lay.spaces_per_mult),
    }
    for want, kw in rows.items():
        assert count_params(TF.FilterModel(use_eig=True, k=1024, **kw)) \
            == want, kw


def _vmap_args(d, **over):
    args = TF.build_parser().parse_args([
        "--device", "cpu", "--net", "MLP", "--use_eig", "--lap_method",
        "sign_inv", "--sign_inv_net", "MLP", "--k", "8", "--img_num", "2",
        "--epochs", "4", "--scan_epochs", "2", "--lr", "1e-3",
        "--results_dir", "", "--mat_path", str(d / "grid.mat"),
        "--label_dir", str(d)])
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _stacked_vs_serial_f64(args, steps=4):
    """`stacked_trainer` against the serial `train_step`, both in f64 from
    the same seeds: the largest relative gap of the per-step losses."""
    p = TF.prepare(args, quiet, torch.device("cpu"), torch.float64)
    seeds = [args.seed * 100003 + i for i in p.img_ids]
    xs = torch.stack([p.x[:, i:i + 1] for i in p.img_ids])
    ys = torch.stack([p.y[:, i:i + 1] for i in p.img_ids])
    serial = []
    for i, seed in enumerate(seeds):
        model = p.make_model(seed)
        opt = adam(model.parameters())
        set_lr(opt, args.lr)
        serial.append([float(TF.train_step(model, opt, p.gb, xs[i], ys[i],
                                           p.mask, p.kwargs)[0])
                       for _ in range(steps)])
    step, _ = TF.stacked_trainer([p.make_model(s) for s in seeds], p,
                                 args.lr)
    stacked = np.array([step(xs, ys)[0].numpy() for _ in range(steps)]).T
    serial = np.array(serial)
    return float(np.max(np.abs(stacked - serial) / np.abs(serial)))


def test_vmapped_matches_serial(real_grid, tmp_path):
    """The vmapped trainer against the serial steps in f64 over 4 steps
    of 2 images (the SignNet-MLP row on the real grid, k = 8; the BasisNet
    row on the tiny grid), losses within 1e-6 relative; through `run` in
    f32, the initial losses (1 epoch) within 1e-4 relative (f32 rounding
    of one forward, which the sum of squared errors enlarges where pred - y
    is small).  Later f32 losses part by more than rounding, vmapped or
    not: Adam moves the weights whose exact gradient is 0 (the DeepSets
    rho's lin2_i behind a BatchNorm) by +-lr on their rounding noise, which
    each summation order draws anew (5e-4 to 1.6e-3 apart after 4 epochs
    here by the thread count), so tests/test_filters_vmap.py's rtol 2e-3
    on them is no test of the port's vmapped math."""
    d, _ = real_grid
    assert _stacked_vs_serial_f64(_vmap_args(d)) <= 1e-6
    tiny_mat(str(tmp_path / "grid.mat"))
    basis = _args(TF, tmp_path, "--net", "DS", "--use_eig", "--lap_method",
                  "basis_inv", "--ign_hidden", "8", "--hidden_channels", "8",
                  "--img_num", "2", "--lr", "1e-3", "--results_dir", "")
    assert _stacked_vs_serial_f64(basis) <= 1e-6
    rel = lambda a, b: float(np.max(np.abs(a[:, 0] - b[:, 0])
                                    / np.abs(b[:, 0])))
    first = [TF.run(_vmap_args(d, epochs=1, scan_epochs=1, vmap_images=v),
                    log=quiet) for v in (1, 2)]
    assert first[0].shape == first[1].shape == (2, 2)
    assert rel(first[1], first[0]) <= 1e-4


def test_vmapped_chunking_covers_all_images(real_grid):
    """3 images in chunks of 2 (one full, one partial); under sign_flip
    each image draws its flips from its own model's generator, so the
    vmapped GcnNet run (no BatchNorm) follows the serial one within 1e-4
    relative."""
    d, _ = real_grid
    out = TF.run(_vmap_args(d, img_num=3, vmap_images=2), log=quiet)
    assert out.shape == (3, 2) and np.all(np.isfinite(out))
    flip = dict(lap_method="sign_flip", net="GcnNet", img_num=3)
    np.testing.assert_allclose(
        TF.run(_vmap_args(d, vmap_images=2, **flip), log=quiet),
        TF.run(_vmap_args(d, **flip), log=quiet), rtol=1e-4)
