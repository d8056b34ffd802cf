"""Terminal UI: progress callbacks, colors, pretty-printers.

Implements the reference's callback protocol
(sgdml/utils/ui.py:61-176): ``callback(current, total, disp_str=...,
sec_disp_str=..., done_with_warning=..., newline_when_done=...)`` with
percent rendering, a DONE/NOT_DONE toggle mode, nested sub-task callbacks,
and memory/matrix pretty-printers.
"""

from __future__ import annotations

import logging
import re
import sys

import numpy as np

# Toggle-mode sentinels (reference: sgdml/__init__.py:31-32).
DONE = 1
NOT_DONE = 0

_TTY = sys.stdout.isatty()


def color_str(string, fore=None, bold=False):
    if not _TTY:
        return string
    codes = []
    colors = {
        'black': 30, 'red': 31, 'green': 32, 'yellow': 33,
        'blue': 34, 'magenta': 35, 'cyan': 36, 'white': 37,
    }
    if fore in colors:
        codes.append(str(colors[fore]))
    if bold:
        codes.append('1')
    if not codes:
        return string
    return '\x1b[%sm%s\x1b[0m' % (';'.join(codes), string)


def white_bold_str(string):
    return color_str(string, bold=True)


def yes_or_no(question: str) -> bool:
    """Interactive y/n prompt (reference: ui.py:39)."""
    reply = str(input(question + ' (y/n): ')).lower().strip()
    if reply and reply[0] == 'y':
        return True
    if reply and reply[0] == 'n':
        return False
    return yes_or_no(question)


def callback(
    current,
    total=1,
    disp_str='',
    sec_disp_str=None,
    done_with_warning=False,
    newline_when_done=True,
):
    """Render task progress.

    Two modes (matching the reference's semantics, ui.py:61-145):
    * toggle: ``total == 1`` and ``current in (DONE, NOT_DONE)`` — renders
      a [ .. ] / [DONE] marker;
    * progress: renders a percentage of ``current / total``.
    """
    is_toggle = total == 1
    if is_toggle:
        is_done = current == DONE
        marker = (
            color_str('[DONE]', fore='yellow' if done_with_warning else 'green')
            if is_done
            else '[' + color_str(' .. ', fore='blue') + ']'
        )
    else:
        is_done = np.isclose(current - total, 0)
        pct = 100 * min(max(current / max(total, 1), 0.0), 1.0)
        marker = '[%3d%%]' % pct
        if is_done:
            marker = color_str(
                '[DONE]', fore='yellow' if done_with_warning else 'green'
            )

    line = '%s %s' % (marker, disp_str)
    if sec_disp_str:
        line += ' ' + color_str(sec_disp_str, fore='cyan')

    end = '\n' if (is_done and newline_when_done) else '\r'
    if _TTY:
        sys.stdout.write('\x1b[2K' + line + end)
        sys.stdout.flush()
    elif is_done:
        print(line)


def sec_callback(current, total=1, sec_disp_str=None, main_callback=None,
                 **kwargs):
    """Nested sub-task progress routed into a parent callback
    (reference: ui.py:150-176)."""
    if main_callback is None:
        return callback(current, total, sec_disp_str=sec_disp_str, **kwargs)
    if total == 1:
        main_callback(NOT_DONE, sec_disp_str=sec_disp_str)
    else:
        main_callback(
            NOT_DONE,
            sec_disp_str='%d/%d %s' % (current, total, sec_disp_str or ''),
        )


def gen_memory_str(n_bytes: int) -> str:
    """Human-readable byte count (reference: ui.py:218-...)."""
    for unit in ('B', 'KB', 'MB', 'GB', 'TB'):
        if abs(n_bytes) < 1024.0 or unit == 'TB':
            return '%.1f %s' % (n_bytes, unit)
        n_bytes /= 1024.0
    return '%d B' % n_bytes


def gen_mat_str(mat, n_decimals: int = 9):
    """Fixed-width matrix string; returns (string, column_width)."""
    mat = np.atleast_2d(np.asarray(mat))
    cells = [['%.*f' % (n_decimals, v) for v in row] for row in mat]
    width = max(len(c) for row in cells for c in row)
    lines = ['\t'.join(c.rjust(width) for c in row) for row in cells]
    return '\n'.join(lines), width


def merge_col_str(left: str, right: str) -> str:
    """Merge two multi-line strings side by side."""
    l_lines, r_lines = left.split('\n'), right.split('\n')
    width = max(len(l) for l in l_lines)
    out = []
    for i in range(max(len(l_lines), len(r_lines))):
        l = l_lines[i] if i < len(l_lines) else ''
        r = r_lines[i] if i < len(r_lines) else ''
        out.append(l.ljust(width) + '\t' + r)
    return '\n'.join(out)


def print_step_title(title: str, sec_title: str = ''):
    width = 80
    pad = width - len(title) - len(sec_title) - 2
    print(
        '\n'
        + white_bold_str(' %s ' % title)
        + ('-' * max(pad, 0))
        + (color_str(sec_title, fore='cyan') if sec_title else '')
    )


def print_two_column_str(left: str, right: str = '', width: int = 80):
    pad = max(width - len(strip_ansi(left)) - len(strip_ansi(right)), 1)
    print(left + ' ' * pad + right)


def print_lattice(lattice):
    from . import io as io_mod

    if lattice is None:
        print('  n/a')
        return
    mat_str, _ = gen_mat_str(lattice, n_decimals=4)
    lengths, angles = io_mod.lattice_vec_to_par(lattice)
    print(mat_str)
    print(
        '  lengths: %s  angles: %s'
        % (
            ', '.join('%.3f' % v for v in lengths),
            ', '.join('%.1f' % v for v in angles),
        )
    )


def strip_ansi(s: str) -> str:
    return re.sub(r'\x1b\[[0-9;]*m', '', s)


def wrap_indent_str(label: str, msg: str, width: int = 80) -> str:
    import textwrap

    return textwrap.fill(
        msg,
        width=width,
        initial_indent=label,
        subsequent_indent=' ' * len(label),
    )


class ColoredFormatter(logging.Formatter):
    """Level-colored log formatter (reference: sgdml/__init__.py:45-92)."""

    LEVEL_COLORS = {
        'DEBUG': 'blue',
        'INFO': None,
        'DONE': 'green',
        'WARNING': 'yellow',
        'ERROR': 'red',
        'CRITICAL': 'red',
    }

    def format(self, record):
        msg = super().format(record)
        color = self.LEVEL_COLORS.get(record.levelname)
        prefix = '[%s]' % record.levelname
        if color:
            prefix = color_str(prefix, fore=color, bold=True)
        return '%s %s' % (prefix, msg)


def init_logging(level=logging.INFO):
    handler = logging.StreamHandler()
    handler.setFormatter(ColoredFormatter('%(message)s'))
    root = logging.getLogger('sgdml_tpu_torch')
    root.handlers[:] = [handler]
    root.setLevel(level)
    return root
