"""The port's fused InfoNCE (`leccr_torch/ops/infonce.py`) against the JAX
package on CPU, in f32.

The plain versions of kernels 9-11 (`infonce_stats`, `infonce_bwd_raw` on
CPU tensors) against JAX's XLA versions (`_stats_xla`, `_bwd_raw_xla`) and
its Pallas kernels in interpret mode (`_stats_pallas`, `_bwd_raw_pallas`)
at M = 300, N = 700, E = 32, so that the JAX tiles pad both axes: ids
distinct, duplicated and different on the two sides, always with a q row
that has no positive.  atol 1e-5; pos_cnt exact.

`infonce_loss`'s value and its gradients in a, b and temp against JAX's
`infonce_loss(impl="pallas", interpret=True)` and against the dense
`soft_label_contrastive_loss`: rtol 1e-5, atol 1e-6.

The kernels' split grid: `split_plan` at chip_smoke's INFONCE_SHAPES and
the edge shapes, for 132 and 8 SMs; the plain versions of the two merges,
fed per-split results of the unsplit plain versions, against the JAX
interpret-mode Pallas kernels (atol 1e-5, pos_cnt exact).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import INFONCE_SHAPES
from leccr_torch.models.losses import soft_label_contrastive_loss
from leccr_torch.ops import infonce as port
from leccr_tpu.ops import infonce as ref

M, N, E = 300, 700, 32
INV_TEMP = np.float32(1.0 / 0.07)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _ids(case, rs):
    """(idx_q, idx_k) of a case; q row 0 never has a positive."""
    if case == "distinct":
        idx_q, idx_k = np.arange(M), np.arange(N)
    elif case == "duplicated":
        idx_k = rs.randint(0, 200, N)
        idx_q = idx_k[rs.randint(0, N, M)]
    else:  # a ring block: q's ids are a shifted window of k's
        idx_q, idx_k = np.arange(M) + 500, np.arange(N)
    idx_q = idx_q.astype(np.int32)
    idx_q[0] = 10 ** 6
    return idx_q, idx_k.astype(np.int32)


@pytest.fixture(params=["distinct", "duplicated", "ring_block"])
def inputs(request):
    rs = np.random.RandomState(len(request.param))
    q, k = _unit(rs.randn(M, E)), _unit(rs.randn(N, E))
    return (q, k, *_ids(request.param, rs))


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_stats_match_jax(inputs):
    got = port.infonce_stats(*_torch(*inputs), float(INV_TEMP))
    assert all(t.dtype == torch.float32 and t.shape == (M,) for t in got)
    args = [jnp.asarray(a) for a in inputs] + [INV_TEMP]
    for want in (ref._stats_xla(*args),
                 ref._stats_pallas(*args, interpret=True)):
        lse, ps, pc = (np.asarray(w) for w in want)
        np.testing.assert_allclose(got[0].numpy(), lse, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), ps, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[2].numpy(), pc)
    assert got[2][0] == 0  # the row without a positive


def test_bwd_raw_matches_jax(inputs):
    lse, _, pc = (np.asarray(x) for x in ref._stats_xla(
        *[jnp.asarray(a) for a in inputs], INV_TEMP))
    dq, dk = port.infonce_bwd_raw(*_torch(*inputs), float(INV_TEMP),
                                  *_torch(lse, pc))
    assert dq.shape == (M, E) and dk.shape == (N, E)
    args = [jnp.asarray(a) for a in inputs] + [INV_TEMP, jnp.asarray(lse),
                                               jnp.asarray(pc)]
    for want in (ref._bwd_raw_xla(*args),
                 ref._bwd_raw_pallas(*args, interpret=True)):
        np.testing.assert_allclose(dq.numpy(), np.asarray(want[0]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(dk.numpy(), np.asarray(want[1]), rtol=0,
                                   atol=1e-5)


def test_inv_temp_may_be_a_tensor(inputs):
    """A one-element temperature tensor gives what the float gives (the
    wrappers never read it back to the host on a card)."""
    t = _torch(*inputs)
    want = port.infonce_stats(*t, float(INV_TEMP))
    got = port.infonce_stats(*t, torch.tensor(INV_TEMP))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("with_idx", [True, False])
def test_infonce_loss_matches_jax_and_dense(with_idx):
    b = M
    rs = np.random.RandomState(7)
    a_np, b_np = _unit(rs.randn(b, E)), _unit(rs.randn(b, E))
    idx_np = rs.randint(0, 120, b).astype(np.int32) if with_idx else None
    temp_np = np.float32(0.07)

    def jax_loss(a, bb, t):
        idx = None if idx_np is None else jnp.asarray(idx_np)
        return ref.infonce_loss(a, bb, t, idx, impl="pallas", interpret=True)

    want, want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(a_np), jnp.asarray(b_np), jnp.asarray(temp_np))
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (a_np, b_np, np.asarray(temp_np))]
    idx = None if idx_np is None else torch.from_numpy(idx_np)
    got = port.infonce_loss(*leaves, idx)
    got_grads = torch.autograd.grad(got, leaves)
    dense_leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    dense = soft_label_contrastive_loss(*dense_leaves, idx)
    dense_grads = torch.autograd.grad(dense, dense_leaves)
    for value, grads in ((np.asarray(want), want_grads),
                         (dense.detach().numpy(), dense_grads)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(value),
                                   rtol=1e-5, atol=1e-6)
        for g, w in zip(got_grads, grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)


def test_cpu_runs_plain_versions_and_other_devices_raise(inputs):
    """CPU tensors take the plain versions (no launch is counted); a
    device with no kernel raises instead of falling back."""
    counts = (port.stats_launches, port.dq_launches, port.dk_launches)
    t = _torch(*inputs)
    lse, _, pc = port.infonce_stats(*t, float(INV_TEMP))
    port.infonce_bwd_raw(*t, float(INV_TEMP), lse, pc)
    assert (port.stats_launches, port.dq_launches,
            port.dk_launches) == counts
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="no fused InfoNCE kernel"):
        port.infonce_stats(*meta, float(INV_TEMP))
    with pytest.raises(ValueError, match="no fused InfoNCE kernel"):
        port.infonce_bwd_raw(*meta, float(INV_TEMP), lse.to("meta"),
                             pc.to("meta"))


def test_bad_shapes_raise():
    q, k = torch.zeros(4, 8), torch.zeros(5, 6)
    with pytest.raises(ValueError, match="share E"):
        port.infonce_stats(q, k, torch.arange(4), torch.arange(5), 1.0)
    with pytest.raises(ValueError, match="idx_q"):
        port.infonce_stats(q, torch.zeros(5, 8), torch.arange(3),
                           torch.arange(5), 1.0)


PLAN_SHAPES = [(m, n) for _, m, n, _ in INFONCE_SHAPES] + [(33, 4097), (1, 1)]


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("which", ["stats", "dq", "dk"])
@pytest.mark.parametrize("m,n", PLAN_SHAPES)
def test_split_plan(m, n, which, sms):
    """Every streamed row in exactly one split, whole tiles but the last,
    no split empty; one split once the row tiles fill the SMs, else ~2
    blocks an SM as far as the streamed tiles go."""
    tile = port.STATS_TILE if which == "stats" else port.BWD_TILE
    rows, cols = (n, m) if which == "dk" else (m, n)
    splits, per = port.split_plan(rows, cols, sms, tile)
    bounds = [(s * per * tile[1], min(cols, (s + 1) * per * tile[1]))
              for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == cols
    assert all(a < b for a, b in bounds)
    assert all(b == c for (_, b), (c, _) in zip(bounds, bounds[1:]))
    row_tiles, col_tiles = -(-rows // tile[0]), -(-cols // tile[1])
    assert 1 <= splits <= col_tiles
    if row_tiles >= sms:
        assert splits == 1
    else:
        assert row_tiles * splits >= min(row_tiles * col_tiles, 1.5 * sms)


def test_split_plan_at_the_path_and_ring_shapes():
    """On an H100's 132 SMs: 8 splits of kernel 9 and 4 of kernels 10/11
    at [4096]² (256 blocks, 2 waves); at the ring block kernel 9 one k tile
    a block (512 blocks) and kernel 10 128 splits of 4 tiles (512 blocks, 4
    waves of 4 tiles: 74 splits of 7 tiles would take 3 waves of 7), kernel
    11 one split; a last split of one column at [33] × [4097]."""
    assert port.split_plan(4096, 4096, 132, port.STATS_TILE) == (8, 4)
    assert port.split_plan(4096, 4096, 132, port.BWD_TILE) == (4, 16)
    assert port.split_plan(256, 32768, 132, port.STATS_TILE) == (256, 1)
    assert port.split_plan(256, 32768, 132, port.BWD_TILE) == (128, 4)
    assert port.split_plan(32768, 256, 132, port.BWD_TILE) == (1, 4)
    splits, per = port.split_plan(33, 4097, 132, port.STATS_TILE)
    assert 4097 - (splits - 1) * per * 128 == 1


def _splits(cols, kind):
    """Bounds of a case's splits of `cols` rows: edges chosen by hand (a
    one-row split first and last; of k's 700 rows, [300, 699) holds no
    positive of the distinct and ring cases' q rows), or kernel 9's plan
    for 8 SMs."""
    if kind == "edges":
        edges = [0, 1, min(300, cols // 2), cols - 1, cols]
    else:
        splits, per = port.split_plan(M, cols, 8, port.STATS_TILE)
        edges = [min(cols, s * per * 128) for s in range(splits + 1)]
    return list(zip(edges, edges[1:]))


@pytest.mark.parametrize("kind", ["edges", "plan"])
def test_merged_stats_partials_match_jax(inputs, kind):
    q, k, iq, ik = _torch(*inputs)
    partials = []
    for a, b in _splits(N, kind):
        lse, ps, pc = port.infonce_stats_reference(q, k[a:b], iq, ik[a:b],
                                                   float(INV_TEMP))
        partials.append(torch.stack([lse, torch.ones_like(lse), ps, pc]))
    got = port.merge_stats_partials(torch.stack(partials))
    want = ref._stats_pallas(*[jnp.asarray(a) for a in inputs], INV_TEMP,
                             interpret=True)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2][0] == 0  # q row 0 has no positive anywhere


def test_merge_takes_an_empty_split():
    """A split that saw no valid column (max −inf, sum 0) changes nothing
    and gives no NaN, first, in the middle or alone."""
    full = torch.tensor([[1.5, 2.0], [3.0, 0.5], [0.7, -1.0], [1.0, 0.0]])
    empty = torch.tensor([[-math.inf] * 2, [0.0] * 2, [0.0] * 2, [0.0] * 2])
    want = port.merge_stats_partials(full[None])
    for parts in ([empty, full], [full, empty], [empty, full, empty]):
        got = port.merge_stats_partials(torch.stack(parts))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    lse, ps, pc = port.merge_stats_partials(empty[None])
    assert torch.isneginf(lse).all() and not torch.isnan(lse).any()


@pytest.mark.parametrize("kind", ["edges", "plan"])
def test_merged_bwd_partials_match_jax(inputs, kind):
    q, k, iq, ik = _torch(*inputs)
    lse, _, pc = port.infonce_stats_reference(q, k, iq, ik, float(INV_TEMP))
    dq = port.merge_bwd_partials(torch.stack([
        port.infonce_bwd_dq_reference(q, k[a:b], iq, ik[a:b],
                                      float(INV_TEMP), lse, pc)
        for a, b in _splits(N, kind)]))
    dk = port.merge_bwd_partials(torch.stack([
        port.infonce_bwd_dk_reference(q[a:b], k, iq[a:b], ik,
                                      float(INV_TEMP), lse[a:b], pc[a:b])
        for a, b in _splits(M, kind)]))
    want = ref._bwd_raw_pallas(*[jnp.asarray(a) for a in inputs], INV_TEMP,
                               *[jnp.asarray(x.numpy()) for x in (lse, pc)],
                               interpret=True)
    np.testing.assert_allclose(dq.numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(dk.numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-5)
