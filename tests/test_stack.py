"""
``SeismicGFLibrary.stack_all`` (the one kinematic stack) against the
float64 host reference ``stack_all_numpy``: both interpolations at
three shapes, under vmap, and with the patch sum split into blocks
(:data:`~beat_tpu.ffi.gflibrary.STACK_BLOCK_BYTES`) against one block.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from beat_tpu.ffi import gflibrary
from beat_tpu.ffi.gflibrary import SeismicGFLibrary, stack_all_numpy

#: float32 sums of 4 x npatches weighted samples against float64
RTOL = 1e-5

SHAPES = {"tiny": (1, 1, 2, 2, 8), "bench_like": (4, 12, 6, 16, 32),
          "many_patches": (3, 37, 4, 9, 16)}


def make(T, P, D, S, N, seed=0):
    rng = np.random.default_rng(seed)
    lib = SeismicGFLibrary(
        data=jnp.asarray(rng.normal(size=(T, P, D, S, N)).astype(np.float32)),
        duration_min=0.5, duration_sampling=0.5, starttime_min=0.0,
        starttime_sampling=0.25)
    # ranges reach past both grid ends: the indices clamp
    d = rng.uniform(0.3, 0.5 * D + 0.4, (P,)).astype(np.float32)
    s = rng.uniform(-0.2, 0.25 * S + 0.2, (T, P)).astype(np.float32)
    w = rng.uniform(0, 3, (P,)).astype(np.float32)
    return lib, d, s, w


def close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=RTOL * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("interp", ["nearest_neighbor", "multilinear"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_stack_matches_reference(shape, interp):
    lib, d, s, w = make(*SHAPES[shape])
    got = np.asarray(lib.stack_all(jnp.asarray(d), jnp.asarray(s),
                                   jnp.asarray(w), interp))
    close(got, stack_all_numpy(lib, d, s, w, interp))


@pytest.mark.parametrize("interp", ["nearest_neighbor", "multilinear"])
def test_stack_vmapped_over_chains(interp):
    lib, *_ = make(*SHAPES["bench_like"])
    chains = [make(*SHAPES["bench_like"], seed=k)[1:] for k in range(1, 5)]
    d, s, w = (np.stack(x) for x in zip(*chains))
    got = np.asarray(jax.jit(jax.vmap(
        lambda a, b, c: lib.stack_all(a, b, c, interp)))(d, s, w))
    for i in range(len(chains)):
        close(got[i], stack_all_numpy(lib, d[i], s[i], w[i], interp))


@pytest.mark.parametrize("block_patches", [5, 37])
@pytest.mark.parametrize("interp", ["nearest_neighbor", "multilinear"])
def test_blocked_equals_single_block(monkeypatch, interp, block_patches):
    """The patch sum in blocks of 5 (7 full blocks + a remainder of 2)
    equals the one-block sum, values and slip gradient."""
    lib, d, s, w = make(*SHAPES["many_patches"])
    T, P, _, _, N = lib.data.shape

    def run():
        f = jax.jit(lambda ww: lib.stack_all(jnp.asarray(d), jnp.asarray(s),
                                             ww, interp))
        g = jax.grad(lambda ww: jnp.sum(f(ww) ** 2))
        return np.asarray(f(jnp.asarray(w))), np.asarray(g(jnp.asarray(w)))

    monkeypatch.setattr(gflibrary, "STACK_BLOCK_BYTES", T * N * 4 * P)
    assert lib.patch_block() == P
    one, g_one = run()
    monkeypatch.setattr(gflibrary, "STACK_BLOCK_BYTES",
                        T * N * 4 * block_patches)
    assert lib.patch_block() == block_patches
    blocked, g_blocked = run()
    close(blocked, one)
    close(g_blocked, g_one)


def test_patch_block_from_shapes():
    """The block bound follows the shapes: the Laquila library
    (12 targets x 512 samples) stacks 21 patches per step; a small one
    stacks all of them at once."""
    def lib_of(T, P, N):
        return SeismicGFLibrary(
            data=jax.ShapeDtypeStruct((T, P, 10, 32, N), jnp.float32),
            duration_min=0.5, duration_sampling=0.5, starttime_min=0.0,
            starttime_sampling=0.25)

    assert lib_of(12, 500, 512).patch_block() == 21
    assert lib_of(8, 12, 256).patch_block() == 12
    assert lib_of(4096, 3, 1024).patch_block() == 1


def test_unknown_interpolation():
    lib, d, s, w = make(*SHAPES["tiny"])
    with pytest.raises(NotImplementedError):
        lib.stack_all(d, s, w, "cubic")
