"""HSLab (headless label editor) + HGraf (SVG canvas) tests."""

import os

import numpy as np
import pytest

from htk_jax.io.mlf import load_label_file
from htk_jax.tools import hslab
from htk_jax.utils.graf import HGraf

from _synth import write_wav


def test_graf_primitives_svg():
    g = HGraf(100, 50, title="t<est")
    g.set_colour("red")
    g.draw_line(0, 0, 99, 49)
    g.fill_rectangle(10, 10, 20, 20)
    g.set_colour(15)  # palette index BLACK
    g.printf(5, 40, 'hi & "bye"')
    svg = g.to_svg()
    assert svg.startswith("<svg")
    assert "<title>t&lt;est</title>" in svg
    assert 'stroke="red"' in svg and 'fill="red"' in svg
    assert "hi &amp; &quot;bye&quot;" in svg
    assert 'fill="black"' in svg


@pytest.fixture
def wav(tmp_path):
    x = (3000 * np.sin(np.arange(16000) / 20)).astype(np.int16)
    p = tmp_path / "u.wav"
    write_wav(str(p), x)
    return p


def test_hslab_label_edit_save_render(wav, tmp_path):
    cmds = tmp_path / "cmds"
    svg = tmp_path / "view.svg"
    cmds.write_text(
        "label 0.0 0.3 sil\n"
        "label 0.3 0.72 speech\n"
        "label 0.72 1.0 silX\n"
        "rename 2 sil\n"
        "adjust 1 0.3 0.7\n"
        "label 0.7 1.0 tail\n"
        "delete 3\n"
        f"render {svg}\n"
        "save\n"
    )
    assert hslab.run(["-e", str(cmds), str(wav)]) == 0
    tr = load_label_file(str(tmp_path / "u.lab"))
    assert [l.name for l in tr.labels] == ["sil", "speech", "sil"]
    assert tr.labels[1].start == 3000000  # 0.3 s in 100ns units
    assert tr.labels[1].end == 7000000
    s = svg.read_text()
    assert "speech" in s and "<polyline" in s or "<line" in s

    # round-trip: reload the labels and re-render zoomed
    cmds2 = tmp_path / "cmds2"
    out2 = tmp_path / "zoom.svg"
    cmds2.write_text(f"zoom 0.2 0.8\nrender {out2}\nquit\n")
    assert hslab.run(["-e", str(cmds2), "-l", str(tmp_path / "u.lab"),
                      str(wav)]) == 0
    assert os.path.exists(out2)


def test_hslab_mlf_output(wav, tmp_path):
    cmds = tmp_path / "cmds"
    cmds.write_text("label 0.0 0.5 aa\nsave\n")
    mlf = tmp_path / "out.mlf"
    assert hslab.run(["-e", str(cmds), "-i", str(mlf), str(wav)]) == 0
    text = mlf.read_text()
    assert text.startswith("#!MLF!#")
    assert "aa" in text
