"""The port's Foldseek and MMseqs commands (create-foldseekdb,
convert-foldseekdb, mmseqs-index-dump; io/foldseek.py) byte for byte
against ``reseek_tpu.cli.main``: every file of the Foldseek DB, the FASTA
and .cal it converts back to, and the text dump of a hits DB that the
test writes."""

import pytest

from reseek_tpu_torch.encoder.dss import encode_chain, feature_string
from reseek_tpu_torch.io.mufasta import seq_to_fasta
from reseek_tpu_torch.io.reader import read_chains

from test_torch_cli_io import both, inputs  # noqa: F401

# the 14 files of a Foldseek DB (reseek_tpu's, verified against the
# reference binary's -create_foldseekdb)
DB_FILES = sorted(["db", "db.dbtype", "db.index", "db.lookup", "db.source",
                   "db_ca", "db_ca.dbtype", "db_ca.index", "db_h",
                   "db_h.dbtype", "db_h.index", "db_ss", "db_ss.dbtype",
                   "db_ss.index"])


@pytest.fixture(scope="module")
def tdi(inputs, tmp_path_factory):
    """A 3Di FASTA of the 16 chains (their Mu letters stand for 3Di)."""
    path = tmp_path_factory.mktemp("tdi") / "q16.3di.fa"
    with open(path, "w") as f:
        for c in read_chains(inputs["q16"]):
            seq_to_fasta(f, c.label, feature_string(encode_chain(c), "Mu"))
    return str(path)


@pytest.mark.parametrize("dupes", [1, 2])
def test_create_foldseekdb(inputs, tdi, tmp_path, dupes):
    _, err, files = both(tmp_path, ["create-foldseekdb", inputs["q16"],
                                    "--3di", tdi, "--output", "{d}/db",
                                    "-n", str(dupes)])
    assert sorted(files) == DB_FILES
    assert err.endswith(f"{16 * dupes} entries -> {{d}}/db\n")


def test_convert_foldseekdb_round_trip(inputs, tdi, tmp_path):
    """create-foldseekdb then convert-foldseekdb: the .cal equals the
    source .cal byte for byte (the int16-delta codec keeps 0.1 A), the
    3Di FASTA the one given."""
    _, _, files = both(tmp_path / "create", [
        "create-foldseekdb", inputs["q16"], "--3di", tdi, "--output",
        "{d}/db"])
    db = tmp_path / "db"
    db.mkdir()
    for name, data in files.items():
        (db / name).write_bytes(data)
    _, err, back = both(tmp_path / "convert", [
        "convert-foldseekdb", str(db / "db"), "--fasta", "{d}/aa.fa",
        "--3di", "{d}/3di.fa", "--cal", "{d}/back.cal"])
    assert back["back.cal"] == open(inputs["q16"], "rb").read()
    assert back["3di.fa"] == open(tdi, "rb").read()
    assert back["aa.fa"].count(b">") == 16


def test_mmseqs_index_dump(tmp_path):
    """A hits DB of three records (tabs, a non-printing byte, an empty
    hit list): the dump, its counts and the index walk."""
    recs = [b"q1\tt1\t0.5\nq1\tt2\t0.1\n\x00", b"q2\tt9\x01\n\x00", b"\x00"]
    db = tmp_path / "hits"
    with open(db, "wb") as f, open(f"{db}.index", "w") as ix:
        pos = 0
        for i, r in enumerate(recs):
            f.write(r)
            ix.write(f"{i}\t{pos}\t{len(r)}\n")
            pos += len(r)
    (tmp_path / "hits.dbtype").write_bytes((0xC000).to_bytes(4, "little"))
    _, err, files = both(tmp_path, ["mmseqs-index-dump", str(db),
                                    "--output", "{d}/dump.txt"])
    assert err.endswith("3 records, 3 hits, 1 non-printing bytes\n")
    assert b"q2\tt9@" in files["dump.txt"]
    _, err, files = both(tmp_path / "quiet", ["mmseqs-index-dump", str(db)])
    assert not files and "3 records" in err
