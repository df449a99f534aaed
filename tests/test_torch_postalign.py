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
from reseek_tpu_torch.ops.postalign import (MAX_CLUSTER, PI, lddt_batch,
                                            lddt_batch_ref, lddt_cluster,
                                            walk_traceback_batch,
                                            walk_traceback_batch_ref)
from reseek_tpu_torch.ops.sw_align import pack_tb

Q100 = os.path.join(os.path.dirname(__file__), "golden", "q100.cal")
LDDT_TOL = 1e-6
# the test workers share the host's cores: one torch thread each keeps the
# plain versions' many small ops from contending for them
torch.set_num_threads(1)


def _walk_case(rng, shape):
    """Seeded S batches: None, ten random ragged pairs of 30 x 45; "tiles",
    300 x 200 (three row tiles of the packed layout at R = 4) with a
    positive diagonal from row 100 to the last; "diagonal", self-pairs of
    260 residues (a long diagonal); "gap", 200 x 300 with diagonals that
    join only through a gap of 100 columns at rows 127/128, the last row of
    the first tile and the first of the second.  Row 0 of each batch has
    no positive cell."""
    if shape is None:
        return None
    la, lb = {"tiles": (300, 200), "diagonal": (260, 260),
              "gap": (200, 300)}[shape]
    b = 4
    s = rng.normal(-1.0, 1.0, (b, la, lb)).astype(np.float32)
    i = np.arange(la)[:, None]
    j = np.arange(lb)[None, :]
    if shape == "tiles":
        on = i == j + 100
    elif shape == "diagonal":
        on = i == j
    else:
        on = ((i == j) & (i <= 127)) | ((j == i + 100) & (i >= 128))
    s[:, on] = rng.normal(3.0, 0.5, (b, int(on.sum())))
    s[0] = -1.0
    return s


def _longest_run(codes, code) -> int:
    best = run = 0
    for c in codes:
        run = run + 1 if c == code else 0
        best = max(best, run)
    return best


@pytest.mark.parametrize("seed,integer,shape", [
    pytest.param(0, True, None, id="0-True"),
    pytest.param(1, False, None, id="1-False"),
    pytest.param(2, False, "tiles", id="tiles"),
    pytest.param(3, False, "diagonal", id="diagonal"),
    pytest.param(4, True, "gap", id="gap")])
def test_walk_matches_jax(seed, integer, shape):
    """The plain walk over the packed layout against the JAX scan on the
    Pallas traceback, exactly: ragged random pairs, and paths that cross
    row tiles and many 64-column windows of the kernel."""
    rng = np.random.default_rng(seed)
    s = _walk_case(rng, shape)
    if s is None:
        b, la, lb = 10, 30, 45
        s = np.full((b, la, lb), NEG, np.float32)
        for k in range(b):
            na, nb = rng.integers(3, la + 1), rng.integers(3, lb + 1)
            s[k, :na, :nb] = (rng.integers(-3, 4, (na, nb)) if integer
                              else rng.normal(0, 2, (na, nb)))
        s[0] = -1.0      # no positive cell: empty path
    elif integer:
        s = np.round(s)
    la, lb = s.shape[1:]
    best, bi, bj, tb = sw_traceback_pallas(jnp.asarray(s), -1.5, -0.25)
    want = postalign_jax.walk_traceback_batch(tb, best, bi, bj)
    # the port's walk reads the packed layout of its stage-3 kernel
    packed = pack_tb(torch.from_numpy(np.array(tb)), la, lb)
    got = walk_traceback_batch_ref(
        packed, *(torch.from_numpy(np.array(x)) for x in (best, bi, bj)), la)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[2][0] == 0
    if shape is not None:
        lo_a, plen, path = got[0].numpy(), got[2].numpy(), got[3].numpy()
        assert (plen[1:] > 190).all() and (lo_a[1:] < 128).all()
        assert (np.asarray(bi)[1:] >= 128).all()
    if shape == "gap":
        # a run of more than 64 I codes, from row 128's column 228 to row
        # 127's column 127
        assert min(_longest_run(p, PI) for p in path[1:]) > 64


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


def _kernel_tiles(n):
    """The LDDT kernel's work split (csrc/postalign.cu lddt_kernel), step
    by step: tile k of the column-pair triangle decoded to (I, J), I <= J;
    lane l (row c = 32 I + l) meets column 32 J + ((l + s) mod 32) at
    steps s = 0..31, or on a diagonal tile s = 1..16 with s = 16 on lanes
    0..15 only; pairs with a column >= n are skipped.  Yields (c, o)."""
    nt = -(-n // 32)
    for k in range(nt * (nt + 1) // 2):
        j = int((np.sqrt(np.float32(8 * k + 1)) - 1) * 0.5)
        while j * (j + 1) // 2 > k:
            j -= 1
        while (j + 1) * (j + 2) // 2 <= k:
            j += 1
        i = k - j * (j + 1) // 2
        diag = i == j
        for lane in range(32):
            for s in (range(1, 17) if diag else range(32)):
                if diag and s == 16 and lane >= 16:
                    continue
                c, o = 32 * i + lane, 32 * j + (lane + s) % 32
                if c < n and o < n:
                    yield c, o


@pytest.mark.parametrize("n", [0, 1, 2, 33, 512, 1023])
def test_lddt_split_covers_each_column_pair_once(n):
    got = sorted((min(c, o), max(c, o)) for c, o in _kernel_tiles(n))
    want = [(c, o) for c in range(n) for o in range(c + 1, n)]
    assert got == want


def test_lddt_cluster_rule():
    """Blocks per pair: several for launches of few pairs, never more than
    a cluster holds, and only while each warp keeps two tiles."""
    assert lddt_cluster(213, 512, 132) == 4
    assert lddt_cluster(1000, 512, 132) == 1
    assert lddt_cluster(3, 1024, 132) == MAX_CLUSTER
    assert lddt_cluster(1, 2048, 132) == MAX_CLUSTER
    assert lddt_cluster(1, 64, 132) == 1
    for b in (1, 2, 3, 50, 213, 600):
        for m in (7, 128, 512, 1024, 2048, 7680):
            c = lddt_cluster(b, m, 132)
            nt = -(-m // 32)
            assert c in (1, 2, 4, 8)
            assert c == 1 or 2 * c * 8 <= nt * (nt + 1) // 2


def test_lddt_at_the_boundaries_matches_jax():
    """Coordinates built to sit on the R0^2 gate (d^2 = 225) and on each
    threshold (|d1 - d2| = 0.5, 1, 2, 4), and just off them: the plain
    version against the JAX function, `risky` equal and every pair not
    flagged within LDDT_TOL."""
    cases = []
    for d2 in (0.5, 1.0, 2.0, 4.0):
        for off in (0.0, 1e-5, 0.25):
            cases.append((10.0, 10.0 + d2 + off))   # a threshold
    cases += [(15.0, 15.0), (15.0, 14.9), (15.0 + 1e-4, 16.0),
              (15.5, 15.5), (3.0, 3.2)]             # the gate
    b, m = len(cases), 4
    cq = np.zeros((b, m, 3), np.float32)
    ct = np.zeros((b, m, 3), np.float32)
    for k, (dq, dt) in enumerate(cases):
        # columns 0 and 1 at the case's distances, 2 and 3 far away
        cq[k, 1, 0], ct[k, 1, 0] = dq, dt
        cq[k, 2:, 1] = ct[k, 2:, 1] = (100.0, 107.0)
    valid = np.ones((b, m), bool)
    valid[-1, 3] = False
    ncols = valid.sum(1).astype(np.int32)
    got, risky = lddt_batch_ref(*(torch.from_numpy(x)
                                  for x in (cq, ct, valid, ncols)))
    want, wrisky = postalign_jax.lddt_batch(
        jnp.asarray(cq), jnp.asarray(ct), jnp.asarray(valid),
        jnp.asarray(ncols), with_risky=True)
    assert np.array_equal(risky.numpy(), np.asarray(wrisky))
    assert risky.numpy()[[0, 3, 6, 9, 12, 13]].all()
    ok = ~risky.numpy()
    assert ok.any()
    assert np.max(np.abs(got.numpy() - np.asarray(want))[ok]) <= LDDT_TOL
