"""Capability parity on the in-repo circuit corpus (examples/).

Every TB family passes plaintext-differential against its golden model on
the corpus the TBs load (missing blobs fall back to the generators, which
the TB machinery handles via _load_or_gen).
"""

import pytest

from oece_tpu.harness import tb as tb_mod
from oece_tpu.utils.cli import Options

REF = tb_mod.R


@pytest.fixture()
def ref_corpus(monkeypatch):
    monkeypatch.setattr(tb_mod, "R", REF)
    return REF


@pytest.mark.parametrize("bench", sorted(tb_mod.BENCHES))
def test_tb_plaintext_vs_reference_corpus(bench, ref_corpus):
    opt = Options(plaintext_only=True, num_test_loops=4)
    results = tb_mod.BENCHES[bench](opt)
    assert results, bench
    bad = [r.summary() for r in results if not r.passed]
    assert not bad, f"{bench}: {bad}"
