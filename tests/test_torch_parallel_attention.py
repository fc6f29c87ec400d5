"""The port's sequence-parallel attention over two gloo ranks
(``jimm_tpu_torch/parallel/{seqpar,ulysses,ring_attention}.py``) against
JAX's same functions on two virtual CPU devices, on the same inputs: each
rank runs its chunk of the sequence, forward and backward with its chunk
of the cotangent, and the chunks reassembled must match JAX's output and
``jax.vjp`` gradients in f32 at ``tests/test_seqpar.py``'s tolerances
(atol 2e-5 forward, 1e-4 gradients).

The port's ``impl="flash"`` runs the flash kernels' plain versions here
(CPU tensors), and is held to JAX's ``impl="einsum"`` (exact attention
either way in f32). Cases: the seqpar ring (softmax, masked with padding
across the shard boundary, sigmoid, masked sigmoid, causal einsum),
Ulysses (softmax, masked, sigmoid), and the ring of
``ring_attention.py`` (einsum, causal einsum, causal flash, causal zigzag
flash in the zigzag layout)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from jimm_tpu.parallel.ring_attention import ring_attention as jax_ring
from jimm_tpu.parallel.ring_attention import zigzag_shard as jax_zigzag
from jimm_tpu.parallel.seqpar import ring_attention_sp as jax_ring_sp
from jimm_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from jimm_tpu_torch.parallel.ring_attention import zigzag_shard
import torch
import torch_parallel_cases as cases
from torch_rank_pool import RankPool

FWD_ATOL, GRAD_ATOL = 2e-5, 1e-4
B, S, N, D = 2, 16, 4, 8


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    # every call has the pool's timeout (60 s)
    p = RankPool(2, tmp_path_factory.mktemp("ranks"), timeout=60)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.asarray(jax.devices()[:2]), ("seq",))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda: rng.standard_normal((B, S, N, D)).astype(np.float32)  # noqa
    q, k, v, do = f(), f(), f(), f()
    mask = np.ones((B, S), bool)
    mask[0, 6:11] = False    # across the shard boundary at 8
    mask[1, 12:] = False     # trailing padding
    return q, k, v, do, mask


def _jax(fn, q, k, v, do):
    def fwd_bwd(q, k, v, do):
        o, vjp = jax.vjp(fn, q, k, v)
        return o, vjp(do)

    o, grads = jax.jit(fwd_bwd)(*map(jnp.asarray, (q, k, v, do)))
    return np.asarray(o), [np.asarray(g) for g in grads]


def _check(pool, scheme, jax_fn, masked=False, **kw):
    q, k, v, do, mask = _inputs()
    if kw.get("zigzag"):
        q, k, v, do = (np.asarray(jax_zigzag(jnp.asarray(x), 2))
                       for x in (q, k, v, do))
    want_o, want_g = _jax(jax_fn(mask if masked else None), q, k, v, do)
    res = pool.run(cases.attention, scheme, q, k, v, do,
                   mask if masked else None, **kw)
    o = np.concatenate([r["o"] for r in res], axis=1)
    np.testing.assert_allclose(o, want_o, atol=FWD_ATOL)
    for j in range(3):
        got = np.concatenate([r["grads"][j] for r in res], axis=1)
        np.testing.assert_allclose(got, want_g[j], atol=GRAD_ATOL,
                                   err_msg=f"{scheme} {kw} grad {j}")


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("kind,masked", [("softmax", False),
                                         ("softmax", True),
                                         ("sigmoid", False),
                                         ("sigmoid", True)])
def test_seqpar_ring_matches_jax(pool, jax_mesh, impl, kind, masked):
    def jax_fn(mask):
        return lambda q, k, v: jax_ring_sp(q, k, v, mask=mask, kind=kind,
                                           mesh=jax_mesh, impl="einsum")
    _check(pool, "ring_sp", jax_fn, masked=masked, kind=kind, impl=impl)


def test_seqpar_causal_ring_matches_jax(pool, jax_mesh):
    def jax_fn(mask):
        return lambda q, k, v: jax_ring_sp(q, k, v, is_causal=True,
                                           mesh=jax_mesh, impl="einsum")
    _check(pool, "ring_sp", jax_fn, is_causal=True, impl="einsum")


@pytest.mark.parametrize("kind,masked", [("softmax", False),
                                         ("softmax", True),
                                         ("sigmoid", False)])
def test_ulysses_matches_jax(pool, jax_mesh, kind, masked):
    def jax_fn(mask):
        return lambda q, k, v: jax_ulysses(q, k, v, mask=mask, kind=kind,
                                           mesh=jax_mesh, impl="einsum")
    _check(pool, "ulysses", jax_fn, masked=masked, kind=kind, impl="flash")


@pytest.mark.parametrize("impl,causal,zigzag", [
    ("einsum", False, False), ("einsum", True, False),
    ("flash", True, False), ("flash", True, True)])
def test_ring_attention_matches_jax(pool, jax_mesh, impl, causal, zigzag):
    def jax_fn(mask):
        return lambda q, k, v: jax_ring(q, k, v, mesh=jax_mesh,
                                        is_causal=causal, impl="einsum",
                                        zigzag=zigzag)
    _check(pool, "ring", jax_fn, is_causal=causal, impl=impl, zigzag=zigzag)


def test_zigzag_layout_matches_jax():
    x = np.arange(2 * 24 * 3, dtype=np.float32).reshape(2, 24, 3)
    for n in (2, 3):
        np.testing.assert_array_equal(
            zigzag_shard(torch.from_numpy(x), n).numpy(),
            np.asarray(jax_zigzag(jnp.asarray(x), n)))
