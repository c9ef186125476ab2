"""Number formatting with units, in the reference editor's three styles.

Functional equivalent of ``NumFormatter``
(particle_editor/src/egui_utils/number_formatter.rs — home of the reference's
only live unit test, :232-241):

- **Dashed**: underscore-grouped integers/decimals (1_234_567.89)
- **Scientific**: mantissa x 10^exp with a superscript exponent
- **Metric**: SI prefixes from G (giga) down to f (femto)

with significant-figures control shared by all three. The port's own copy of
``particle_simulator_tpu/utils/numfmt.py`` (only the web editor uses it); the
same value gives the same string (``tests/test_torch_editor.py``).
"""

from __future__ import annotations

import enum
import math

_SUPERSCRIPTS = str.maketrans("0123456789-+", "⁰¹²³⁴⁵⁶⁷⁸⁹⁻⁺")

# G..f like the reference (number_formatter.rs Metric arm)
_SI = [
    (1e9, "G"),
    (1e6, "M"),
    (1e3, "k"),
    (1e0, ""),
    (1e-3, "m"),
    (1e-6, "µ"),
    (1e-9, "n"),
    (1e-12, "p"),
    (1e-15, "f"),
]


class NumFormat(enum.Enum):
    DASHED = "dashed"
    SCIENTIFIC = "scientific"
    METRIC = "metric"


def format_with_underscores(value: str) -> str:
    """Group integer digits by 3 with underscores, leaving sign/decimals
    intact (the reference's unit-tested helper, number_formatter.rs:232-241)."""
    sign = ""
    if value and value[0] in "+-":
        sign, value = value[0], value[1:]
    if "." in value:
        int_part, frac = value.split(".", 1)
        frac = "." + frac
    else:
        int_part, frac = value, ""
    groups = []
    while len(int_part) > 3:
        groups.append(int_part[-3:])
        int_part = int_part[:-3]
    groups.append(int_part)
    return sign + "_".join(reversed(groups)) + frac


def _round_sig(x: float, sig: int) -> float:
    if x == 0.0 or not math.isfinite(x):
        return x
    return round(x, -int(math.floor(math.log10(abs(x)))) + (sig - 1))


def _trim(s: str) -> str:
    return s.rstrip("0").rstrip(".") if "." in s else s


class NumFormatter:
    def __init__(self, fmt: NumFormat = NumFormat.METRIC, significant: int = 4):
        self.fmt = fmt
        self.significant = max(1, significant)

    def format(self, value: float, unit: str = "") -> str:
        if not math.isfinite(value):
            return f"{value}{unit}"
        v = _round_sig(float(value), self.significant)

        if self.fmt == NumFormat.DASHED:
            body = _trim(f"{v:.{max(0, self.significant)}f}") if v else "0"
            return format_with_underscores(body) + unit

        if self.fmt == NumFormat.SCIENTIFIC:
            if v == 0.0:
                return "0" + unit
            # exponent/mantissa from the %e rendering — the exact analog of
            # JS toExponential(sig-1), so the two implementations agree at
            # decade boundaries where floor(log10(abs(v))) of a double can
            # land on either side of an integer
            mant_s, exp_s = f"{v:.{self.significant - 1}e}".split("e")
            exp = int(exp_s)
            mant_s = _trim(mant_s)
            if exp == 0:
                return f"{mant_s}{unit}"
            return f"{mant_s}·10{str(exp).translate(_SUPERSCRIPTS)}{unit}"

        # Metric
        if v == 0.0:
            return "0" + unit
        for scale, prefix in _SI:
            if abs(v) >= scale:
                return _trim(f"{v / scale:.{self.significant - 1}f}") + prefix + unit
        scale, prefix = _SI[-1]
        return _trim(f"{v / scale:.{self.significant - 1}f}") + prefix + unit
