"""Headless drawing primitives (the HGraf role).

`HTKLib/HGraf.c` gives HSLab a tiny immediate-mode drawing API over
Xlib (HDrawLine/HDrawRectangle/HPrintf/... plus button handling); the
canonical distribution also ships `HGraf.null.c`, an empty stub for
display-less builds. This rebuild targets headless compute hosts, so the
equivalent is a vector canvas with the same primitive vocabulary that
renders to SVG — viewable anywhere, diffable in tests, no display or
third-party dependency required.

Coordinates follow HGraf: origin top-left, y growing downwards, pixel
units. Colours are the HGraf palette names (WHITE..BLACK) or any SVG
colour string.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

# HGraf.h colour indices
COLOURS = ["white", "yellow", "orange", "red", "mauve", "purple",
           "darkblue", "lightblue", "darkgreen", "lightgreen",
           "darkbrown", "lightbrown", "lightgray", "gray", "darkgray",
           "black"]


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


class HGraf:
    """An SVG canvas with HGraf's primitive set."""

    def __init__(self, width: int, height: int, title: str = ""):
        self.width = int(width)
        self.height = int(height)
        self.title = title
        self._elems: List[str] = []
        self._colour = "black"
        self._line_width = 1
        self._font_size = 11

    # -- attribute state (HSetColour / HSetLineWidth / HSetFontSize) -----

    def set_colour(self, c) -> None:
        if isinstance(c, int):
            c = COLOURS[c % len(COLOURS)]
        self._colour = c

    def set_line_width(self, w: int) -> None:
        self._line_width = int(w)

    def set_font_size(self, s: int) -> None:
        self._font_size = int(s)

    # -- primitives (HDraw*/HFill*/HPrintf) ------------------------------

    def draw_line(self, x0, y0, x1, y1) -> None:
        self._elems.append(
            f'<line x1="{x0:.1f}" y1="{y0:.1f}" x2="{x1:.1f}" y2="{y1:.1f}" '
            f'stroke="{self._colour}" stroke-width="{self._line_width}"/>')

    def draw_lines(self, pts: Sequence[Tuple[float, float]]) -> None:
        p = " ".join(f"{x:.1f},{y:.1f}" for x, y in pts)
        self._elems.append(
            f'<polyline points="{p}" fill="none" stroke="{self._colour}" '
            f'stroke-width="{self._line_width}"/>')

    def draw_rectangle(self, x0, y0, x1, y1) -> None:
        self._elems.append(
            f'<rect x="{min(x0, x1):.1f}" y="{min(y0, y1):.1f}" '
            f'width="{abs(x1 - x0):.1f}" height="{abs(y1 - y0):.1f}" '
            f'fill="none" stroke="{self._colour}" '
            f'stroke-width="{self._line_width}"/>')

    def fill_rectangle(self, x0, y0, x1, y1) -> None:
        self._elems.append(
            f'<rect x="{min(x0, x1):.1f}" y="{min(y0, y1):.1f}" '
            f'width="{abs(x1 - x0):.1f}" height="{abs(y1 - y0):.1f}" '
            f'fill="{self._colour}" stroke="none"/>')

    def printf(self, x, y, text: str, anchor: str = "start") -> None:
        self._elems.append(
            f'<text x="{x:.1f}" y="{y:.1f}" font-size="{self._font_size}" '
            f'font-family="monospace" text-anchor="{anchor}" '
            f'fill="{self._colour}">{_esc(text)}</text>')

    # -- output ----------------------------------------------------------

    def to_svg(self) -> str:
        head = (
            f'<svg xmlns="http://www.w3.org/2000/svg" '
            f'width="{self.width}" height="{self.height}" '
            f'viewBox="0 0 {self.width} {self.height}">')
        title = f"<title>{_esc(self.title)}</title>" if self.title else ""
        bg = (f'<rect x="0" y="0" width="{self.width}" '
              f'height="{self.height}" fill="white"/>')
        return head + title + bg + "".join(self._elems) + "</svg>"

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_svg())
