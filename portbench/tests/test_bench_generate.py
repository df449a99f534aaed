"""The generator: the same seed gives the same data, the seed changes the
noise and not the sizes, and a job or batch has the same lengths on every
seed."""

import numpy as np
import pytest

from portbench import generate


@pytest.fixture(scope="module")
def sepq():
    return generate.read_cal(generate.data_path("portbench/data/sepq_set.cal"))


def pool(base, seed, n=404):
    return generate.cycled(base, n, 0.25,
                           generate.rng_for(seed, generate.STREAM_DATA))


def test_cycled_repeats_for_a_seed(sepq):
    a, b = pool(sepq, 2**40 + 3), pool(sepq, 2**40 + 3)
    c = pool(sepq, 2**40 + 4)
    assert a.labels == b.labels and np.array_equal(a.coords, b.coords)
    assert a.labels == c.labels and np.array_equal(a.off, c.off)
    assert not np.array_equal(a.coords, c.coords)
    # member m is base m mod len(base), its coordinates within ~7 sigma
    m = 150
    k = m % len(sepq)
    want = sepq.coords[sepq.off[k]:sepq.off[k + 1]]
    got = a.coords[a.off[m]:a.off[m + 1]]
    assert a.seqs[m] == sepq.seqs[k]
    assert np.abs(got - want).max() < 0.25 * 7
    assert 0.2 < np.std(got - want) < 0.3
    assert len(set(a.labels)) == len(a)


@pytest.mark.parametrize("job", [512, 192, 101, 37])
def test_job_lengths_same_on_every_seed(sepq, job):
    keep = np.flatnonzero(sepq.lengths < 500)
    base = generate.subset(sepq, keep)
    p = pool(base, 1, 8300)
    got = []
    for seed in (5, 2**33 + 1, 77):
        rng = generate.rng_for(seed, generate.STREAM_CALLS)
        for _ in range(3):
            m = generate.job_members(len(base), len(p), base.lengths, job,
                                     rng)
            assert len(m) == job == len(set(m.tolist()))
            got.append((seed, m))
    profiles = {tuple(np.sort(p.lengths[m])) for _s, m in got}
    assert len(profiles) == 1
    assert len({tuple(m) for _s, m in got}) == len(got)


def test_pdb90_batches_same_profile_on_every_seed(tiny_root):
    from portbench import harness
    bench = harness.Bench(tiny_root)
    cell = bench.cell("pdb90.fast")
    kind = harness.kind_module(cell["traffic"])
    profiles, labels = set(), set()
    for seed in (11, 2**31 + 9):
        wl = kind.Workload(cell["config"], cell["traffic"], seed, "cpu",
                           root=tiny_root)
        try:
            for _ in range(3):
                b = wl.next_call()
                profiles.add(tuple(sorted(b.lengths)))
                labels.update(b.labels)
        finally:
            wl.close()
    assert len(profiles) == 1
    assert len(labels) == 3 * len(cell["traffic"]["queries"])


def test_mu_fasta_reads_back():
    from portbench.reference.search.prefilter import mu_from_ascii
    mu = np.arange(36, dtype=np.uint8)
    text = generate.mu_fasta(["x"], [mu]).decode()
    assert text.startswith(">x\n")
    letters = text.split("\n")[1]
    assert letters == "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghij"
    back = mu_from_ascii(letters)
    # the reference's g_CharToLetterMu swaps K and L (10 and 11)
    swap = mu.copy()
    swap[[10, 11]] = [11, 10]
    assert np.array_equal(back, swap)
