"""Text normalization for the G2P front-end.

Reimplements the behavior of the reference's preprocessing chain
(reference: data_utils/text_processor.py:121-170): number expansion, accent
strip, lowercase, quote/paren removal, hyphen normalization, charset filter
to ``[a-z !,.?;:]``, punctuation collapse/spacing, and the "i.e." / "etc."
special cases.  The number expansion (the role of ``g2p_en.expand.
normalize_numbers``, unavailable offline) is implemented natively: cardinals,
ordinals, decimals, currency, commas-in-numbers, and year-like reads.
"""
from __future__ import annotations

import re
import unicodedata

PUNCS = "!,.?;:"

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"), (100, "hundred")]

_ORDINAL_UNITS = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _UNITS[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + ("" if rem == 0 else " " + _UNITS[rem])
    for value, name in _SCALES:
        if n >= value:
            major, rem = divmod(n, value)
            words = number_to_words(major) + " " + name
            if rem:
                words += " " + number_to_words(rem)
            return words
    return _UNITS[0]


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    if last in _ORDINAL_UNITS:
        last = _ORDINAL_UNITS[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return (head + " " + last).strip()


def _expand_currency(unit: str, units: str, sub: str, subs: str):
    """Builds an expander for a currency: $12.50 -> twelve dollars fifty
    cents.  The reference's chain only handles ``$`` (g2p_en expand role);
    pounds/euros are a documented quality extension."""
    def expand(m: re.Match) -> str:
        amount = m.group(1).replace(",", "")
        if "." in amount:
            d, c = amount.split(".", 1)
            d, c = int(d or 0), int((c + "0")[:2])
            parts = []
            if d:
                parts.append(number_to_words(d) + " " + (unit if d == 1 else units))
            if c:
                parts.append(number_to_words(c) + " " + (sub if c == 1 else subs))
            return " ".join(parts) or "zero " + units
        d = int(amount)
        return number_to_words(d) + " " + (unit if d == 1 else units)
    return expand


_expand_dollars = _expand_currency("dollar", "dollars", "cent", "cents")
_expand_pounds = _expand_currency("pound", "pounds", "penny", "pence")
_expand_euros = _expand_currency("euro", "euros", "cent", "cents")


def _expand_time(m: re.Match) -> str:
    """Clock times: 5:30 -> five thirty, 5:00 -> five o'clock,
    5:05 -> five oh five.  (The reference leaves the colon, which the
    punctuation pass then reads as a pause.)"""
    h, mi = int(m.group(1)), int(m.group(2))
    if mi == 0:
        return f"{number_to_words(h)} o'clock"
    if mi < 10:
        return f"{number_to_words(h)} oh {_UNITS[mi]}"
    return f"{number_to_words(h)} {number_to_words(mi)}"


def _expand_decade(m: re.Match) -> str:
    """Decades: 1960s -> nineteen sixties, 90s -> nineties,
    1900s -> nineteen hundreds."""
    n = int(m.group(1) + "0")
    words = _expand_year(n) if n >= 1000 else number_to_words(n)
    head, _, last = words.rpartition(" ")
    last = last[:-1] + "ies" if last.endswith("y") else last + "s"
    return (head + " " + last).strip()


def _expand_decimal(m: re.Match) -> str:
    whole, frac = m.group(1), m.group(2)
    digits = " ".join(_UNITS[int(ch)] for ch in frac)
    return f"{number_to_words(int(whole))} point {digits}"


def _expand_year(n: int) -> str:
    """Read 4-digit year-like numbers as pairs (1984 -> nineteen eighty
    four; 1905 -> nineteen oh five), with the g2p_en special cases
    2000 -> two thousand and 2001-2009 -> two thousand N."""
    if n == 2000:
        return "two thousand"
    if 2000 < n < 2010:
        return "two thousand " + _UNITS[n - 2000]
    hi, lo = divmod(n, 100)
    if lo == 0:
        return number_to_words(hi) + " hundred"
    return number_to_words(hi) + " " + ("oh " + _UNITS[lo] if lo < 10 else number_to_words(lo))


def _expand_cardinal(m: re.Match) -> str:
    n = int(m.group(0).replace(",", ""))
    # year-like read only for a bare 4-digit number: "1,234" is a cardinal
    if 1000 <= n <= 2999 and "," not in m.group(0) and len(m.group(0)) == 4:
        return _expand_year(n)
    return number_to_words(n)


def normalize_numbers(text: str) -> str:
    text = re.sub(r"\b([0-9]{1,2}):([0-5][0-9])\b", _expand_time, text)
    text = re.sub(r"\$([0-9,]*\.?[0-9]+)", _expand_dollars, text)
    text = re.sub(r"£([0-9,]*\.?[0-9]+)", _expand_pounds, text)
    text = re.sub(r"€([0-9,]*\.?[0-9]+)", _expand_euros, text)
    text = re.sub(r"\b([0-9]{1,3})0s\b", _expand_decade, text)
    text = re.sub(r"\b([0-9]+)\.([0-9]+)\b", _expand_decimal, text)
    text = re.sub(r"\b([0-9,]*[0-9])(st|nd|rd|th)\b", lambda m: ordinal_to_words(int(m.group(1).replace(",", ""))), text)
    text = re.sub(r"[0-9][0-9,]*", _expand_cardinal, text)
    text = re.sub(r"%", " percent ", text)
    return text


# Spoken forms of common title/register abbreviations.  The reference chain
# (text_processor.py:121-170) leaves these to the charset filter, which reads
# "dr." letter-by-letter; expanding them is a deliberate quality improvement.
_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "missus"), ("mr", "mister"), ("ms", "miss"), ("dr", "doctor"),
        ("prof", "professor"), ("capt", "captain"), ("gen", "general"),
        ("lt", "lieutenant"), ("col", "colonel"), ("sgt", "sergeant"),
        ("maj", "major"), ("rev", "reverend"), ("hon", "honorable"),
        ("jr", "junior"), ("sr", "senior"), ("vs", "versus"),
    ]
]


def preprocess_text(text: str) -> str:
    """Full normalization chain (reference: text_processor.py:121-170).

    Two deliberate deviations from the reference, both defect fixes: title
    abbreviations are expanded to their spoken forms (the reference reads
    "dr." as /D R/), and ``/`` separates its operands like a hyphen (the
    reference's charset filter deletes it, mushing "3/14" into one word).
    """
    text = normalize_numbers(text)
    text = "".join(
        ch for ch in unicodedata.normalize("NFD", text)
        if unicodedata.category(ch) != "Mn"
    )
    text = text.lower()
    for pat, full in _ABBREVIATIONS:
        text = pat.sub(full, text)
    text = re.sub(r"[\'\"()]+", "", text)
    text = re.sub(r"[-/]+", " ", text)
    text = re.sub(rf"[^ a-z{PUNCS}]", "", text)
    text = re.sub(rf" ?([{PUNCS}]) ?", r"\1", text)
    text = re.sub(rf"([{PUNCS}])+", r"\1", text)
    text = text.replace("i.e.", "that is")
    text = text.replace("etc.", "etc")
    text = re.sub(rf"([{PUNCS}])", r" \1 ", text)
    text = re.sub(r"\s+", " ", text)
    return text
