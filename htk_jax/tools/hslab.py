"""HSLab — waveform viewer and label editor (headless redesign).

`HTKTools/HSLab.c` is HTK's interactive X11 labeller: it displays a
waveform with its label segments and edits them with mouse-driven
buttons (Mark, Labelas, Delete, Edit, Adjust, Save, ...). This host has
no display, so the rebuild keeps HSLab's *capabilities* — view a
waveform with its labels, create/delete/rename/adjust segments, write
HTK label files or MLFs — behind a scriptable command interface plus an
SVG renderer (utils/graf.py, the HGraf role). Every button action has a
command equivalent, so labelling sessions are reproducible and testable
instead of mouse-driven.

Usage: HSLab [options] waveformFile

  -e file    read edit commands from file ('-' = stdin)
  -l file    load initial labels from this label file
  -o file    render the final view to this SVG file
  -i mlf     save labels into this MLF (else a .lab next to the wave)
  -y ext     output label extension (default lab)
  -F fmt     source format override (default: sniff/SOURCEFORMAT)
  -T n       trace

Commands (one per line, '#' comments; times in seconds):
  label <t0> <t1> <name>    mark a region and label it (Mark+Labelas)
  delete <idx>              delete label by index (0-based)
  rename <idx> <name>       rename a label            (Edit)
  adjust <idx> <t0> <t1>    move a label's boundaries (Adjust)
  zoom <t0> <t1>            restrict the rendered view
  render <file.svg>         render the current view
  save [file]               write the label file now
  quit                      stop reading commands
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np

from ..io.mlf import MLF, Label, Transcription, load_label_file, save_label_file
from ..io.wavefile import read_wave
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError
from ..utils.graf import HGraf

USAGE = "Usage: HSLab [options] waveformFile"

OPTS = {
    "e": Option("e", 1, "command file ('-' = stdin)"),
    "l": Option("l", 1, "initial label file"),
    "o": Option("o", 1, "render SVG to this file"),
    "i": Option("i", 1, "output MLF"),
    "y": Option("y", 1, "output label extension"),
    "F": Option("F", 1, "source audio format"),
}

TICK_100NS = 1e7  # 100 ns units per second


def render_view(wave: np.ndarray, samp_period: int, labels: List[Label],
                title: str, t0: float = 0.0, t1: Optional[float] = None,
                width: int = 900, height: int = 260) -> HGraf:
    """Waveform min/max envelope + label segments, HSLab's main view."""
    fs = 1e7 / samp_period
    total_s = len(wave) / fs
    if t1 is None or t1 <= t0:
        t1 = total_s
    t0 = max(0.0, t0)
    t1 = min(total_s, t1)
    i0, i1 = int(t0 * fs), max(int(t0 * fs) + 1, int(t1 * fs))
    seg = wave[i0:i1].astype(np.float64)

    g = HGraf(width, height, title=title)
    wave_h = height - 80
    mid = 10 + wave_h / 2

    # frame + midline
    g.set_colour("gray")
    g.draw_rectangle(0.5, 10, width - 0.5, 10 + wave_h)
    g.draw_line(0, mid, width, mid)

    # min/max envelope, one column per pixel
    g.set_colour("darkblue")
    peak = max(1.0, float(np.max(np.abs(seg))) if len(seg) else 1.0)
    cols = np.array_split(seg, width) if len(seg) >= width else \
        [seg[k: k + 1] for k in np.linspace(0, len(seg) - 1, width,
                                            dtype=int)]
    for x, c in enumerate(cols):
        if len(c) == 0:
            continue
        lo = mid - float(np.min(c)) / peak * (wave_h / 2 - 2)
        hi = mid - float(np.max(c)) / peak * (wave_h / 2 - 2)
        g.draw_line(x, lo, x, hi)

    # time axis ticks
    g.set_colour("black")
    g.set_font_size(10)
    n_ticks = 8
    for k in range(n_ticks + 1):
        tx = t0 + (t1 - t0) * k / n_ticks
        x = width * k / n_ticks
        g.draw_line(x, 10 + wave_h, x, 16 + wave_h)
        g.printf(min(x, width - 30), 28 + wave_h, f"{tx:.2f}",
                 anchor="middle" if 0 < k < n_ticks else "start")

    # label band (HSLab's label strip below the waveform)
    band_y0 = 40 + wave_h
    band_y1 = height - 4
    g.set_colour("gray")
    g.draw_rectangle(0.5, band_y0, width - 0.5, band_y1)

    def x_of(t_100ns: float) -> float:
        t_s = t_100ns / TICK_100NS
        return (t_s - t0) / (t1 - t0) * width

    for lab in labels:
        xs, xe = x_of(lab.start), x_of(lab.end or lab.start)
        if xe < 0 or xs > width:
            continue
        g.set_colour("red")
        g.draw_line(xs, band_y0, xs, band_y1)
        g.draw_line(xe, band_y0, xe, band_y1)
        g.set_colour("black")
        g.printf((xs + xe) / 2, (band_y0 + band_y1) / 2 + 4, lab.name,
                 anchor="middle")
    return g


def run(argv: List[str]) -> int:
    ta = parse_args("HSLab", argv, OPTS, min_args=1, usage=USAGE)
    cfg = ta.config
    wav_path = ta.args[0]

    fmt = ta.get("F") or cfg.str_("SOURCEFORMAT", "", module="HWAVE") or None
    if fmt:
        w = read_wave(wav_path, fmt=fmt)
    else:
        from ..io.audio import _sniff_format

        w = read_wave(wav_path, fmt=_sniff_format(wav_path))
    wave, period = w.samples, w.samp_period

    labels: List[Label] = []
    if ta.has("l"):
        labels = list(load_label_file(ta.get("l")).labels)

    stem = os.path.splitext(os.path.basename(wav_path))[0]
    out_ext = ta.get("y", "lab")
    default_out = os.path.join(os.path.dirname(wav_path) or ".",
                               f"{stem}.{out_ext}")
    view = [0.0, None]
    saved = False

    def do_save(path: Optional[str] = None) -> None:
        nonlocal saved
        tr = Transcription(alternatives=[sorted(labels,
                                                key=lambda l: l.start)])
        if ta.has("i"):
            m = MLF()
            m.add(f"*/{stem}.{out_ext}", tr)
            m.save(ta.get("i"), with_times=True)
            if ta.trace:
                print(f"HSLab: wrote {ta.get('i')}")
        else:
            save_label_file(path or default_out, tr)
            if ta.trace:
                print(f"HSLab: wrote {path or default_out}")
        saved = True

    def do_render(path: str) -> None:
        g = render_view(wave, period, sorted(labels, key=lambda l: l.start),
                        title=wav_path, t0=view[0], t1=view[1])
        g.save(path)
        if ta.trace:
            print(f"HSLab: rendered {path}")

    # command stream
    lines: List[str] = []
    if ta.has("e"):
        src = ta.get("e")
        lines = (sys.stdin.read() if src == "-"
                 else open(src).read()).splitlines()

    for ln in lines:
        ln = ln.split("#", 1)[0].strip()
        if not ln:
            continue
        toks = ln.split()
        cmd = toks[0].lower()
        try:
            if cmd == "label":
                t0s, t1s, name = float(toks[1]), float(toks[2]), toks[3]
                labels.append(Label(name=name, start=int(t0s * TICK_100NS),
                                    end=int(t1s * TICK_100NS)))
            elif cmd == "delete":
                labels.pop(int(toks[1]))
            elif cmd == "rename":
                labels[int(toks[1])].name = toks[2]
            elif cmd == "adjust":
                lab = labels[int(toks[1])]
                lab.start = int(float(toks[2]) * TICK_100NS)
                lab.end = int(float(toks[3]) * TICK_100NS)
            elif cmd == "zoom":
                view[0], view[1] = float(toks[1]), float(toks[2])
            elif cmd == "render":
                do_render(toks[1])
            elif cmd == "save":
                do_save(toks[1] if len(toks) > 1 else None)
            elif cmd == "quit":
                break
            else:
                HRError(1630, "HSLab: unknown command '%s'", cmd)
        except (IndexError, ValueError) as ex:
            HError(1630, "HSLab: bad command '%s' (%s)", ln, ex)

    if not saved and labels:
        do_save()
    if ta.has("o"):
        do_render(ta.get("o"))
    if ta.trace:
        print(f"HSLab: {len(wave)} samples, {len(labels)} labels")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
