"""The port's collectives and ring losses over four gloo ranks
(``jimm_tpu_torch/parallel/comm.py``, ``train/losses.py``).

Each collective (``ppermute``, ``all_gather``, ``all_to_all``, ``psum``),
forward and backward, on a mesh axis and on a tuple of axes, against the
dense computation. The ring losses at 2 ranks (the ``data`` axis of a
``{"replica": 2, "data": 2}`` mesh: two rings at once) and at 4 (the
``("replica", "data")`` pair axis) against JAX's ring losses on as many
virtual CPU devices and against the dense loss: the losses, and the
parameter gradients averaged over the ring's ranks (what
``sharding.finish_gradients`` does) against JAX's unsharded gradients, in
f32 at rtol 1e-5 / atol 1e-6 (a gradient off by the ring's size fails)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from jimm_tpu.train import losses as jax_losses
import torch_parallel_cases as cases
from torch_rank_pool import RankPool

AXES = {"replica": 2, "data": 2}
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    # every call has the pool's timeout (60 s)
    p = RankPool(4, tmp_path_factory.mktemp("ranks"), timeout=60)
    yield p
    p.close()


def _groups(results):
    """Results by ring: {ranks tuple: [result by position]}."""
    out = {}
    for r in results:
        out.setdefault(tuple(r.get("ring", ())), []).append(r)
    return out


@pytest.mark.parametrize("axis", ["data", ("replica", "data")])
def test_collectives_match_the_dense_computation(pool, axis):
    rng = np.random.default_rng(0)
    n = 2 if axis == "data" else 4
    x = rng.standard_normal((8, 4 * n)).astype(np.float32)
    w = rng.standard_normal(4096).astype(np.float32)
    res = pool.run(cases.collectives, AXES, axis, x, w)
    rows = x.shape[0] // n
    # the ranks of one ring: positions 0..n-1 (two rings when n == 2)
    rings = [sorted((r for r in res if r["size"] == n),
                    key=lambda r: r["index"])]
    if n == 2:
        rings = [res[0:2], res[2:4]]
    for ring in rings:
        ring = sorted(ring, key=lambda r: r["index"])
        piece = [x[p * rows:(p + 1) * rows] for p in range(n)]
        wy = {name: [r[name][2] for r in ring] for name in ring[0]
              if isinstance(ring[0][name], tuple)}
        for p, r in enumerate(ring):
            y, g, _ = r["ppermute"]
            np.testing.assert_array_equal(y, piece[(p - 1) % n])
            np.testing.assert_array_equal(g, wy["ppermute"][(p + 1) % n])
            y, g, _ = r["ppermute_partial"]
            np.testing.assert_array_equal(
                y, piece[0] if p == n - 1 else np.zeros_like(piece[0]))
            np.testing.assert_array_equal(
                g, wy["ppermute_partial"][n - 1] if p == 0
                else np.zeros_like(piece[0]))
            y, g, _ = r["all_gather"]
            np.testing.assert_array_equal(y, np.concatenate(piece, 1))
            c = piece[0].shape[1]
            np.testing.assert_allclose(
                g, sum(wq[:, p * c:(p + 1) * c] for wq in wy["all_gather"]),
                rtol=RTOL, atol=ATOL)
            y, g, _ = r["all_to_all"]
            split = c // n
            np.testing.assert_array_equal(y, np.concatenate(
                [pc[:, p * split:(p + 1) * split] for pc in piece], 0))
            np.testing.assert_array_equal(g, np.concatenate(
                [wy["all_to_all"][j][p * rows:(p + 1) * rows]
                 for j in range(n)], 1))
            y, g, _ = r["psum"]
            np.testing.assert_allclose(y, sum(piece), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(g, sum(wy["psum"]), rtol=RTOL,
                                       atol=ATOL)


def test_hybrid_mesh_and_batch_shards(pool):
    batch = np.arange(8 * 3).reshape(8, 3)
    res = pool.run(cases.layouts, batch)
    for r in res:
        # the dcn axis outermost; rank r at the row-major coordinates of r
        assert r["shape"] == {"replica": 2, "data": 2}
        data = r["rank"] % 2
        np.testing.assert_array_equal(r["dp"]["x"],
                                      batch[4 * data:4 * data + 4])
        np.testing.assert_array_equal(r["dp"]["y"][1],
                                      batch[4 * data:4 * data + 4])
        np.testing.assert_array_equal(
            r["pair"], batch[2 * r["rank"]:2 * r["rank"] + 2])


def _inputs(n, seed=1, b_per=3, d_in=6, d=5):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(b_per * n, d_in), f(b_per * n, d_in), f(d_in, d) * 0.5,
            f(d_in, d) * 0.5, np.float32(np.log(10.0)), np.float32(-2.0))


def _jax_reference(kind, n, axis, x_img, x_txt, w_img, w_txt, scale, bias):
    """JAX's ring loss on n virtual devices, its gradients, and the dense
    loss."""
    names = (axis,) if isinstance(axis, str) else axis
    shape = (n,) if len(names) == 1 else (2, n // 2)
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)

    def loss(params, ring):
        wi, wt, s, bb = params
        img, txt = jnp.asarray(x_img) @ wi, jnp.asarray(x_txt) @ wt
        if kind == "siglip_ring":
            if ring:
                return jax_losses.ring_sigmoid_loss(img, txt, s, bb,
                                                    mesh=mesh, axis_name=axis)
            return jax_losses.sigmoid_pairwise_loss(img, txt, s, bb)
        if ring:
            return jax_losses.ring_clip_infonce_loss(img, txt, s, mesh=mesh,
                                                     axis_name=axis)
        return jax_losses.clip_softmax_loss(img, txt, s)

    params = tuple(jnp.asarray(p) for p in (w_img, w_txt, scale, bias))
    ring_val, ring_grads = jax.jit(jax.value_and_grad(
        lambda p: loss(p, True)))(params)
    dense_val = loss(params, False)
    return float(ring_val), [np.asarray(g) for g in ring_grads], \
        float(dense_val)


@pytest.mark.parametrize("kind", ["siglip_ring", "clip_ring"])
@pytest.mark.parametrize("axis", ["data", ("replica", "data")])
def test_ring_losses_and_gradients_match_jax(pool, kind, axis):
    n = 2 if axis == "data" else 4
    inputs = _inputs(n)
    ring_val, jax_grads, dense_val = _jax_reference(kind, n, axis, *inputs)
    res = pool.run(cases.ring_loss, AXES, axis, kind, *inputs)
    for ring in _groups(res).values():
        assert len(ring) == n
        for r in ring:
            np.testing.assert_allclose(r["loss"], ring_val, rtol=RTOL)
            np.testing.assert_allclose(r["loss"], dense_val, rtol=RTOL)
        # the replicated parameters' gradients averaged over the ring
        for j, want in enumerate(jax_grads):
            if kind == "clip_ring" and j == 3:  # InfoNCE has no bias
                assert all(r["grads"][3] is None for r in ring)
                continue
            got = sum(r["grads"][j] for r in ring) / n
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{kind} {axis} param {j}")
