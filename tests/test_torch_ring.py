"""The port's ring InfoNCE (`leccr_torch.parallel.ring`).

- The one-process replay `ring_infonce` at W in {1, 2, 4, 8}, dense and
  fused (plain blocks on the CPU), against JAX's `ring_infonce` on W of
  the 8 virtual CPU devices (tests/test_parallel.py:31-66, 104-131), with
  duplicate ids and with idx None: the loss within 1e-5 relative, the
  gradients in feat_a, feat_b and temp within 1e-5 of max(the tensor's
  largest |g|, 1e-4 · the largest |g| of the three) (the floored measure
  of PERF.md §2).
- Both equal `models.losses.soft_label_contrastive_loss` of the whole batch
  at the same tolerances.
- The point-to-point ring `ring_infonce_local` over W = 2 and 4 gloo
  processes equals the replay bit for bit: the loss on every rank, each
  rank's feature gradients, and the temperature's on every rank.
"""

import functools
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leccr_torch.models.losses import soft_label_contrastive_loss
from leccr_torch.parallel.ring import ring_infonce
from leccr_tpu.config import ParallelConfig
from leccr_tpu.parallel.mesh import make_mesh
from leccr_tpu.parallel.ring import ring_infonce as jax_ring_infonce

ROOT = Path(__file__).resolve().parent.parent
B, E, TEMP = 32, 16, 0.07
TIMEOUT_S = 120


def _feats(seed=11):
    rs = np.random.RandomState(seed)
    a = rs.randn(B, E).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b = rs.randn(B, E).astype(np.float32)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    idx = rs.randint(0, B // 2, size=B).astype(np.int32)  # duplicates
    return a, b, idx


def _port(a, b, idx, fn):
    x = torch.from_numpy(a).requires_grad_()
    y = torch.from_numpy(b).requires_grad_()
    t = torch.tensor(TEMP, requires_grad=True)
    loss = fn(x, y, t, None if idx is None else torch.from_numpy(idx))
    loss.backward()
    return (loss.item(), x.grad.numpy(), y.grad.numpy(),
            np.float32(t.grad.item()))


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    floor = 1e-4 * max(np.abs(np.asarray(g)).max() for g in want[1:])
    for g, w in zip(got[1:], want[1:]):
        err = np.abs(np.asarray(g) - np.asarray(w)).max()
        assert err <= 1e-5 * max(np.abs(np.asarray(w)).max(), floor)


@functools.lru_cache(maxsize=None)
def _jax_ring(world, impl):
    """jit(value_and_grad) of JAX's ring_infonce in (feat_a, feat_b, temp)
    on a data mesh of `world` virtual CPU devices."""
    mesh = make_mesh(ParallelConfig(data=world, model=1),
                     jax.devices()[:world])
    return jax.jit(jax.value_and_grad(
        lambda x, y, t, i: jax_ring_infonce(mesh, x, y, t, i, impl=impl),
        argnums=(0, 1, 2)))


@pytest.mark.parametrize("ids", ["dup", "none"])
@pytest.mark.parametrize("impl", ["dense", "fused"])
@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_replay_matches_jax_ring(world, impl, ids):
    a, b, idx = _feats()
    idx = idx if ids == "dup" else None
    # JAX's ring with idx None takes arange(B): one compiled program
    jidx = jnp.arange(B, dtype=jnp.int32) if idx is None else jnp.asarray(idx)
    value, grads = _jax_ring(world, impl)(
        jnp.asarray(a), jnp.asarray(b), jnp.float32(TEMP), jidx)
    want = (float(value), *(np.asarray(g) for g in grads))
    got = _port(a, b, idx,
                lambda x, y, t, i: ring_infonce(x, y, t, i, world, impl))
    _close(got, want)
    _close(got, _port(a, b, idx, soft_label_contrastive_loss))


WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch
    rank, world, port, out, temp = (int(sys.argv[1]), int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4],
                                    float(sys.argv[5]))
    torch.set_num_threads(1)
    from leccr_torch.parallel.mesh import DataMesh
    from leccr_torch.parallel.ring import ring_infonce_local

    mesh = DataMesh.create(None, rank, world,
                           init_method=f"tcp://localhost:{port}",
                           device="cpu")
    data = np.load(f"{out}.npz")
    a, b, idx = data["a"], data["b"], data["idx"]
    rows = slice(rank * len(a) // world, (rank + 1) * len(a) // world)
    results = {}
    for impl in ("dense", "fused"):
        for ids in ("dup", "none"):
            x = torch.from_numpy(a[rows]).requires_grad_()
            y = torch.from_numpy(b[rows]).requires_grad_()
            t = torch.tensor(temp, requires_grad=True)
            i = torch.from_numpy(idx[rows]) if ids == "dup" else None
            loss = ring_infonce_local(x, y, t, i, mesh, impl)
            loss.backward()
            results[impl, ids] = (loss.detach(), x.grad, y.grad, t.grad)
    torch.save(results, f"{out}.rank{rank}")
    mesh.destroy()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [2, 4])
def test_p2p_ring_equals_the_replay_bit_for_bit(world, tmp_path):
    port, out = _free_port(), tmp_path / "ring"
    a, b, idx = _feats()
    np.savez(f"{out}.npz", a=a, b=b, idx=idx)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(port),
         str(out), str(TEMP)], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    ranks = [torch.load(f"{out}.rank{r}") for r in range(world)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the workers' thread count
    try:
        for impl in ("dense", "fused"):
            for ids in ("dup", "none"):
                x = torch.from_numpy(a).requires_grad_()
                y = torch.from_numpy(b).requires_grad_()
                t = torch.tensor(TEMP, requires_grad=True)
                loss = ring_infonce(
                    x, y, t, torch.from_numpy(idx) if ids == "dup" else None,
                    world, impl)
                loss.backward()
                got = [rank[impl, ids] for rank in ranks]
                for rank_loss, _, _, rank_dt in got:
                    assert torch.equal(rank_loss, loss.detach())
                    assert torch.equal(rank_dt, t.grad)
                assert torch.equal(torch.cat([g[1] for g in got]), x.grad)
                assert torch.equal(torch.cat([g[2] for g in got]), y.grad)
    finally:
        torch.set_num_threads(threads)
