"""TIMIT 60->48->39/41 phone mappings (counterpart of
mdd_tpu/lexicon/timit.py).

The table content mirrors the reference map file
egs/attention_aug/conf/phones.60-48-39.map (columns: 60-set, 48-set,
39/41-set; `q` maps to nothing and is dropped).  The "60-41" mapping is the
39-set column of that file, which additionally keeps ah0/er0 — hence 41
distinct outputs (reference local/normalize_phone.py:19-51).
"""

from __future__ import annotations

# phone60: (phone48, phone39or41). `q` is deleted entirely.
_MAP_ROWS = {
    "aa": ("aa", "aa"), "ae": ("ae", "ae"), "ah": ("ah", "ah"),
    "ao": ("ao", "ao"), "aw": ("aw", "aw"), "ax": ("ax", "ah0"),
    "ax-h": ("ax", "ah0"), "axr": ("er0", "er0"), "ay": ("ay", "ay"),
    "b": ("b", "b"), "bcl": ("vcl", "sil"), "ch": ("ch", "ch"),
    "d": ("d", "d"), "dcl": ("vcl", "sil"), "dh": ("dh", "dh"),
    "dx": ("dx", "dh"), "eh": ("eh", "eh"), "el": ("el", "l"),
    "em": ("m", "m"), "en": ("en", "n"), "eng": ("ng", "ng"),
    "epi": ("epi", "sil"), "er": ("er", "er"), "ey": ("ey", "ey"),
    "f": ("f", "f"), "g": ("g", "g"), "gcl": ("vcl", "sil"),
    "h#": ("sil", "sil"), "hh": ("hh", "hh"), "hv": ("hh", "hh"),
    "ih": ("ih", "ih"), "ix": ("ix", "ih"), "iy": ("iy", "iy"),
    "jh": ("jh", "jh"), "k": ("k", "k"), "kcl": ("cl", "sil"),
    "l": ("l", "l"), "m": ("m", "m"), "n": ("n", "n"),
    "ng": ("ng", "ng"), "nx": ("n", "n"), "ow": ("ow", "ow"),
    "oy": ("oy", "oy"), "p": ("p", "p"), "pau": ("sil", "sil"),
    "pcl": ("cl", "sil"), "q": (None, None), "r": ("r", "r"),
    "s": ("s", "s"), "sh": ("sh", "sh"), "t": ("t", "t"),
    "tcl": ("cl", "sil"), "th": ("th", "th"), "uh": ("uh", "uh"),
    "uw": ("uw", "uw"), "ux": ("uw", "uw"), "v": ("v", "v"),
    "w": ("w", "w"), "y": ("y", "y"), "z": ("z", "z"), "zh": ("zh", "zh"),
}

TIMIT_60_48 = {k: v[0] for k, v in _MAP_ROWS.items() if v[0] is not None}
TIMIT_60_41 = {k: v[1] for k, v in _MAP_ROWS.items() if v[1] is not None}
# 48->39: project through the 60-set (only well-defined for 48-set symbols).
TIMIT_48_39 = {}
for _p60, (_p48, _p39) in _MAP_ROWS.items():
    if _p48 is not None:
        TIMIT_48_39.setdefault(_p48, _p39)


def map_timit_phones(phones: list[str], scheme: str = "60-41") -> list[str]:
    """Map a TIMIT phone sequence between sets, dropping deleted phones.

    Mirrors reference local/normalize_phone.py:46-51 (unmapped phones like
    `q` are removed rather than kept).
    """
    table = {"60-48": TIMIT_60_48, "60-41": TIMIT_60_41, "48-39": TIMIT_48_39}[scheme]
    return [table[p] for p in phones if p in table]
