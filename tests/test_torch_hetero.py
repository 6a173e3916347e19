"""The port's rank-heterogeneous NanoAdapters (``repro_torch.core.hetero``)
against the JAX package's (``repro.core.hetero``).

Adapters and Fisher diagonals come from numpy seeds and go to both packages
as they are. pad, truncate and the merge are held at 1e-6 of ‖ref‖∞ (pad and
truncate exactly); the merge also with ``None`` Fishers, over a grid of rank
pairs (the JAX package's convex-hull property test, which runs under
hypothesis there), and with coordinates where no client has Fisher mass,
which must merge to exactly 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adapters as jnano
from repro.core import hetero as jhetero
from repro_torch.core import adapters as nano
from repro_torch.core import hetero
from repro_torch.core.aggregation import fisher_merge

from test_torch_training import one_torch_thread, rel_err  # noqa: F401

D = 16


def _adapter(rng, d, r, scale=0.1):
    return {"down": (rng.standard_normal((d, r)) * scale).astype(np.float32),
            "up": (rng.standard_normal((r, d)) * scale).astype(np.float32)}


def _nanoedge(rng, r, d=D):
    return {"text": _adapter(rng, d, r), "image": _adapter(rng, d, r)}


def _fisher(rng, tree):
    return {m: {n: (np.abs(rng.standard_normal(x.shape)) + 0.1).astype(np.float32)
                for n, x in a.items()} for m, a in tree.items()}


def _port(tree):
    return None if tree is None else {m: {n: torch.from_numpy(x) for n, x in a.items()}
                                      for m, a in tree.items()}


def _jax(tree):
    return None if tree is None else {m: {n: jnp.asarray(x) for n, x in a.items()}
                                      for m, a in tree.items()}


def _assert_close(got, want, tol, what=""):
    assert sorted(got) == sorted(want), what
    for m in want:
        for n in want[m]:
            assert tuple(got[m][n].shape) == tuple(want[m][n].shape), (what, m, n)
            assert rel_err(got[m][n], want[m][n]) <= tol, (what, m, n)


def test_pad_and_truncate_match_reference():
    rng = np.random.default_rng(0)
    adp = _nanoedge(rng, 4)
    for rmax in (4, 8, 12):
        _assert_close(hetero.pad_nanoedge(_port(adp), rmax),
                      jhetero.pad_nanoedge(_jax(adp), rmax), 0.0, f"pad {rmax}")
    full = _nanoedge(rng, 8)
    for r in (1, 4, 8):
        _assert_close(hetero.truncate_nanoedge(_port(full), r),
                      jhetero.truncate_nanoedge(_jax(full), r), 0.0, f"truncate {r}")
    back = hetero.pad_nanoedge(hetero.truncate_nanoedge(_port(full), 4), 8)
    assert torch.equal(back["text"]["down"][:, :4], torch.from_numpy(full["text"]["down"][:, :4]))
    assert not back["text"]["up"][4:].any()


def test_padding_preserves_the_adapter_function():
    """A rank-r pair padded to R at the client's own scale alpha/r computes
    the same adapter, through the plain path and the kernel wrapper."""
    rng = np.random.default_rng(1)
    raw = _adapter(rng, D, 4)
    adp = _port({"a": raw})["a"]
    padded = hetero.pad_adapter(adp, 8)
    x = torch.from_numpy(rng.standard_normal((5, D)).astype(np.float32))
    for use_pallas in (False, True):
        y1 = nano.nano_adapter_apply(adp, x, rank=4, alpha=8.0, use_pallas=use_pallas)
        y2 = nano.nano_adapter_apply(padded, x, rank=4, alpha=8.0, use_pallas=use_pallas)
        assert rel_err(y2, y1.numpy()) <= 1e-6
    want = jnano.nano_adapter_apply(_jax({"a": raw})["a"], jnp.asarray(x.numpy()), rank=4,
                                    alpha=8.0)
    assert rel_err(nano.nano_adapter_apply(padded, x, rank=4, alpha=8.0), want) <= 1e-6


@pytest.mark.parametrize("with_fisher", [True, False], ids=["fisher", "none"])
@pytest.mark.parametrize("sizes", [None, (3.0, 1.0, 2.0)], ids=["uniform", "sized"])
def test_hetero_merge_matches_reference(with_fisher, sizes):
    rng = np.random.default_rng(2)
    ranks = [2, 4, 8]
    thetas = [_nanoedge(rng, r) for r in ranks]
    fishers = [_fisher(rng, t) if with_fisher else None for t in thetas]
    got = hetero.hetero_fisher_merge([_port(t) for t in thetas], [_port(f) for f in fishers],
                                     ranks, sizes)
    want = jhetero.hetero_fisher_merge([_jax(t) for t in thetas], [_jax(f) for f in fishers],
                                       ranks, sizes)
    _assert_close(got, want, 1e-6, "merge")
    assert got["text"]["down"].shape == (D, 8) and got["text"]["up"].shape == (8, D)
    # coordinates only the rank-8 client holds take its values
    np.testing.assert_allclose(got["text"]["down"][:, 4:].numpy(),
                               thetas[2]["text"]["down"][:, 4:], rtol=1e-6, atol=0)


def test_no_fisher_mass_merges_to_exactly_zero():
    """Ranks 2 and 4 merged in rank-8 space: columns (rows) 4-7 have no
    client's Fisher mass, 0/(0 + eps) = 0 exactly, never NaN; the plain
    merge equals the fisher_merge kernel wrapper's on the padded trees."""
    rng = np.random.default_rng(3)
    ranks = [2, 4]
    thetas = [_nanoedge(rng, r) for r in ranks]
    fishers = [_fisher(rng, t) for t in thetas]
    got = hetero.hetero_fisher_merge([_port(t) for t in thetas], [_port(f) for f in fishers],
                                     ranks, rank_max=8)
    want = jhetero.hetero_fisher_merge([_jax(t) for t in thetas], [_jax(f) for f in fishers],
                                       ranks, rank_max=8)
    _assert_close(got, want, 1e-6, "merge at rank_max 8")
    for a in got.values():
        assert not torch.isnan(a["down"]).any() and not torch.isnan(a["up"]).any()
        assert torch.equal(a["down"][:, 4:], torch.zeros_like(a["down"][:, 4:]))
        assert torch.equal(a["up"][4:], torch.zeros_like(a["up"][4:]))
    kernel = fisher_merge([hetero.pad_nanoedge(_port(t), 8) for t in thetas],
                          [hetero.pad_nanoedge(_port(f), 8) for f in fishers], use_pallas=True)
    _assert_close(kernel, {m: {n: x.numpy() for n, x in a.items()} for m, a in got.items()},
                  1e-6, "kernel wrapper on padded trees")


@pytest.mark.parametrize("r1", range(1, 7))
@pytest.mark.parametrize("r2", range(1, 7))
def test_hetero_merge_convex_hull(r1, r2):
    """With ``None`` Fishers every merged coordinate lies between the padded
    inputs (the JAX package's property), and the merge matches JAX's."""
    rng = np.random.default_rng(r1 * 7 + r2)
    rmax = max(r1, r2)
    t1, t2 = {"text": _adapter(rng, 8, r1)}, {"text": _adapter(rng, 8, r2)}
    got = hetero.hetero_fisher_merge([_port(t1), _port(t2)], [None, None], [r1, r2])
    want = jhetero.hetero_fisher_merge([_jax(t1), _jax(t2)], [None, None], [r1, r2])
    _assert_close(got, want, 1e-6, "convex hull")
    p1 = hetero.pad_nanoedge(_port(t1), rmax)["text"]["down"]
    p2 = hetero.pad_nanoedge(_port(t2), rmax)["text"]["down"]
    m = got["text"]["down"]
    assert bool((m >= torch.minimum(p1, p2) - 1e-6).all())
    assert bool((m <= torch.maximum(p1, p2) + 1e-6).all())
