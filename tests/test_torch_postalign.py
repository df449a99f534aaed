"""Port's traceback walk and LDDT (reseek_tpu_torch/ops/postalign.py)
against reseek_tpu/ops/postalign_jax.py and the exact host LDDT.

Walk: exact.  LDDT: within 1e-6 of the JAX version with equal `risky`
flags, and within 1e-6 of ops/lddt.lddt_mu_fast (the FMA-contracted
reference) on pairs not flagged risky; flagged pairs are the ones the
engine recomputes on the host."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reseek_tpu.io.reader import read_chains
from reseek_tpu.ops import postalign_jax
from reseek_tpu.ops.lddt import lddt_mu_fast
from reseek_tpu.ops.sw_np import NEG
from reseek_tpu.ops.sw_pallas import sw_traceback_pallas
from reseek_tpu_torch.ops.postalign import (lddt_batch, lddt_batch_ref,
                                            walk_traceback_batch,
                                            walk_traceback_batch_ref)

Q100 = os.path.join(os.path.dirname(__file__), "golden", "q100.cal")
LDDT_TOL = 1e-6
# the test workers share the host's cores: one torch thread each keeps the
# plain versions' many small ops from contending for them
torch.set_num_threads(1)


@pytest.mark.parametrize("seed,integer", [(0, True), (1, False)])
def test_walk_matches_jax(seed, integer):
    rng = np.random.default_rng(seed)
    b, la, lb = 10, 30, 45
    s = np.full((b, la, lb), NEG, np.float32)
    for k in range(b):
        na, nb = rng.integers(3, la + 1), rng.integers(3, lb + 1)
        s[k, :na, :nb] = (rng.integers(-3, 4, (na, nb)) if integer
                          else rng.normal(0, 2, (na, nb)))
    s[0] = -1.0      # no positive cell: empty path
    best, bi, bj, tb = sw_traceback_pallas(jnp.asarray(s), -1.5, -0.25)
    want = postalign_jax.walk_traceback_batch(tb, best, bi, bj)
    got = walk_traceback_batch_ref(
        *(torch.from_numpy(np.array(x)) for x in (tb, best, bi, bj)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[2][0] == 0


def _aligned_columns(rng, chains, n_pairs, m):
    """Coordinates of random monotone column matches between q100 chains:
    (cq, ct [n, m, 3], valid [n, m], ncols [n], (coords, positions))."""
    cq = np.zeros((n_pairs, m, 3), np.float32)
    ct = np.zeros((n_pairs, m, 3), np.float32)
    valid = np.zeros((n_pairs, m), bool)
    ncols = np.zeros(n_pairs, np.int32)
    src = []
    for k in range(n_pairs):
        a, b = chains[rng.integers(len(chains))], chains[
            rng.integers(len(chains))]
        n = 0 if k == 0 else int(rng.integers(2, min(m, len(a), len(b)) + 1))
        pq = np.sort(rng.choice(len(a), n, replace=False))
        pt = np.sort(rng.choice(len(b), n, replace=False))
        cq[k, :n] = a.coords[pq]
        ct[k, :n] = b.coords[pt]
        valid[k, :n] = True
        ncols[k] = n
        src.append((a.coords, b.coords, pq, pt))
    return cq, ct, valid, ncols, src


@pytest.fixture(scope="module")
def columns():
    chains = read_chains(Q100)[:16]
    return _aligned_columns(np.random.default_rng(5), chains, 24, 96)


def test_lddt_matches_jax(columns):
    cq, ct, valid, ncols, _ = columns
    got, risky = lddt_batch_ref(*(torch.from_numpy(x)
                                  for x in (cq, ct, valid, ncols)))
    want, wrisky = postalign_jax.lddt_batch(
        jnp.asarray(cq), jnp.asarray(ct), jnp.asarray(valid),
        jnp.asarray(ncols), with_risky=True)
    assert np.array_equal(risky.numpy(), np.asarray(wrisky))
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= LDDT_TOL


def test_lddt_matches_exact_host(columns):
    cq, ct, valid, ncols, src = columns
    got, risky = lddt_batch_ref(*(torch.from_numpy(x)
                                  for x in (cq, ct, valid, ncols)))
    assert got[0] == 0.0     # no aligned columns
    checked = 0
    for k, (coords_q, coords_t, pq, pt) in enumerate(src):
        if risky[k]:
            continue
        want = lddt_mu_fast(coords_q, coords_t, pq, pt)
        assert abs(float(got[k]) - want) <= LDDT_TOL, k
        checked += 1
    assert checked >= len(src) // 2


def test_lddt_without_risky_and_wrappers_on_cpu(columns):
    cq, ct, valid, ncols, _ = columns
    args = [torch.from_numpy(x) for x in (cq, ct, valid, ncols)]
    before = (lddt_batch.launches, walk_traceback_batch.launches)
    plain = lddt_batch(*args, with_risky=False)
    out, _ = lddt_batch_ref(*args)
    assert torch.equal(plain, out)
    assert (lddt_batch.launches, walk_traceback_batch.launches) == before
