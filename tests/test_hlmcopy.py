"""HLMCopy — LM-vocabulary dictionary construction (HLMTools/HLMCopy.c)."""

import os

import pytest

from htk_jax.io.dictionary import read_dict
from htk_jax.tools import hlmcopy
from htk_jax.utils.errors import HTKError


@pytest.fixture
def dicts(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    open("src.dic", "w").write(
        "a ah\n"
        "b b iy\n"
        "b [b] 0.5 b ih\n"
    )
    open("extra.dic", "w").write(
        "b B OH\n"      # shadowed by src
        "c s iy\n"
    )
    return tmp_path


class TestHLMCopy:
    def test_wordlist_and_fill_from_extras(self, dicts, capsys):
        open("wl", "w").write("b\nc\n")
        assert hlmcopy.run(["-T", "1", "-d", "extra.dic", "-w", "wl",
                            "src.dic", "out.dic"]) == 0
        v = read_dict("out.dic")
        assert sorted(v.words) == ["b", "c"]
        # src wins over extras; both prons kept, probs/outsyms survive
        assert [p.phones for p in v.words["b"].prons] == \
            [["b", "iy"], ["b", "ih"]]
        assert v.words["b"].prons[1].prob == 0.5
        assert v.words["b"].prons[1].out_sym == "b"
        assert [p.phones for p in v.words["c"].prons] == [["s", "iy"]]
        assert "2 words" in capsys.readouterr().out

    def test_max_prons(self, dicts):
        assert hlmcopy.run(["-n", "1", "src.dic", "out.dic"]) == 0
        v = read_dict("out.dic")
        assert len(v.words["b"].prons) == 1

    def test_missing_word_errors_unless_o(self, dicts, capsys):
        open("wl", "w").write("a\nzzz\n")
        with pytest.raises(HTKError) as e:
            hlmcopy.run(["-w", "wl", "src.dic", "out.dic"])
        assert "16450" in str(e.value)
        assert hlmcopy.run(["-o", "-w", "wl", "src.dic", "out.dic"]) == 0
        assert sorted(read_dict("out.dic").words) == ["a"]
        assert os.path.exists("out.dic")
