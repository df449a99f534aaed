"""The output check on the CPU (the port's device engine on its plain
kernel versions, tiny sizes): sound runs are correct; the control and each
fault a cell can have are not.

Faults, planted under the harness in the program's call: half of the
call's chains or queries left out, and one answer altered where it is
produced.  (The cells run on one chip and carry no state from call to
call: no exchange between chips to leave out, no step to repeat.)"""

import pytest

from portbench import harness
from portbench.kinds import fast_search, self_search

CELLS = ["scop40.fast", "scop40.sensitive", "scop40.verysensitive",
         "pdb90.fast"]


def run(root, cell, program="port"):
    rec = harness.run(cell, 2**31 + 77, 0.0, trace=False, device="cpu",
                      program=program, root=root)
    return rec


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    rec = run(tiny_root, cell)
    assert harness.is_correct(rec), rec["check"]
    assert rec["check"]["info"]["rows_compared"] > 0


@pytest.mark.parametrize("cell", ["scop40.fast", "scop40.sensitive",
                                  "pdb90.fast"])
def test_control_is_not_correct(tiny_root, cell):
    rec = run(tiny_root, cell, program="control")
    assert not harness.is_correct(rec)
    assert rec["check"]["numbers"]["rows_differing"][0] > 0


def half_of_the_job(orig):
    def port(self, members, out):
        return orig(self, members[:len(members) // 2], out)
    return port


def half_of_the_batch(orig):
    def port(self, batch, out):
        from portbench import generate
        return orig(self, generate.subset(batch, range(len(batch) // 2)),
                    out)
    return port


def altered_answer(orig):
    def port(self, inputs, out):
        import io
        mine = io.StringIO()
        stats = orig(self, inputs, mine)
        rows = mine.getvalue().splitlines()
        cols = rows[0].split("\t")
        cols[6] = "%.3g" % (float(cols[6]) * 1.5 + 1e-30)   # the E-value
        rows[0] = "\t".join(cols)
        out.write("".join(r + "\n" for r in rows))
        return stats
    return port


@pytest.mark.parametrize("cell,module,fault", [
    ("scop40.fast", self_search, half_of_the_job),
    ("scop40.fast", self_search, altered_answer),
    ("scop40.sensitive", self_search, half_of_the_job),
    ("scop40.sensitive", self_search, altered_answer),
    ("pdb90.fast", fast_search, half_of_the_batch),
    ("pdb90.fast", fast_search, altered_answer)])
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, module, fault):
    monkeypatch.setattr(module.Workload, "_port",
                        fault(module.Workload._port))
    rec = run(tiny_root, cell)
    assert not harness.is_correct(rec), rec["check"]
