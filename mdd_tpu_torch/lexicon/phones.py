"""Phone-set core: CMU39(+AH0/ER0) inventory, normalization rules, IPA maps
(counterpart of mdd_tpu/lexicon/phones.py).

The inventory and the L2-ARCTIC TextGrid normalization rules mirror the
reference recipe (egs/attention_aug/local/l2arctic_prep.py:60-143 and
egs/attention_aug/data/units); the CMU<->IPA display table mirrors
egs/attention_aug/dict/phonetic_dict.py:21-63.  Everything here is plain
data + pure functions.
"""

from __future__ import annotations

import string

# The 39-phone CMU set (lowercase), in the canonical order of the committed
# `data/units` vocabulary file (reference egs/attention_aug/data/units).
# This ordering matters: vocab ids are assigned in file order after the
# reserved {blank:0, UNK:1} entries.
CANONICAL_UNITS_41 = [
    "sil", "sh", "iy", "hh", "ae", "d", "y", "er", "aa", "r", "k", "s",
    "uw", "t", "ih", "n", "g", "w", "ao", "dh", "l", "ow", "m", "eh",
    "oy", "ay", "b", "v", "f", "z", "th", "ah", "p", "ey", "ng", "ch",
    "uh", "zh", "jh", "aw", "err",
]

# The 43-unit variant produced by the 0329 data prep, which additionally
# keeps the reduced vowels ah0 (AX/schwa) and er0 (AXR) as distinct units
# (reference l2arctic_prep.py:66-91).  Order follows the reference
# utils/tools.py:58-104 index table.
CANONICAL_UNITS_43 = [
    "sil", "sh", "iy", "hh", "ae", "d", "y", "er0", "aa", "r", "k", "s",
    "uw", "t", "ih", "n", "g", "w", "ao", "dh", "l", "ow", "m", "eh",
    "oy", "ay", "b", "er", "v", "f", "z", "th", "ah", "ah0", "p", "ey",
    "ng", "ch", "uh", "zh", "jh", "aw", "err",
]

# Plain CMU39 (no sil/err/reduced vowels).
CMU39 = [p for p in CANONICAL_UNITS_41 if p not in ("sil", "err")]

# Vowel / consonant partition (reference utils/tools.py:56-57).
VOWELS = [
    "iy", "aa", "ae", "eh", "ah", "ao", "ih", "ey", "aw", "ay", "er",
    "uw", "uh", "oy", "ow", "ah0", "er0",
]
CONSONANTS = [
    "w", "dh", "y", "hh", "ch", "jh", "th", "zh", "d", "ng", "b", "g",
    "f", "k", "m", "l", "n", "s", "r", "t", "v", "z", "p", "sh",
]

# CMU (uppercase, stress-stripped except AH0/ER0) -> IPA display symbols
# (reference dict/phonetic_dict.py:21-63, "wiki" table).
CMU_TO_IPA = {
    "AA": "a", "AE": "æ", "AH0": "ə", "AH": "ʌ",
    "AO": "ɔ", "AW": "aʊ", "AY": "aɪ", "EH": "e",
    "ER": "ɜ", "ER0": "ər", "EY": "eɪ", "IH": "ɪ",
    "IY": "i", "OW": "oʊ", "OY": "ɔɪ", "UH": "ʊ",
    "UW": "u", "B": "b", "CH": "tʃ", "D": "d", "DH": "ð",
    "F": "f", "G": "g", "HH": "h", "JH": "dʒ", "K": "k", "L": "l",
    "M": "m", "N": "n", "NG": "ŋ", "P": "p", "R": "r", "S": "s",
    "SH": "ʃ", "T": "t", "TH": "θ", "V": "v", "W": "w",
    "Y": "j", "Z": "z", "ZH": "ʒ",
}
IPA_TO_CMU = {v: k for k, v in CMU_TO_IPA.items()}


def _normalize_common(phn: str) -> str | None:
    """Shared tail of the annotated/canonical normalization rules."""
    if phn in ("sp", "SIL", "", " ", "spn"):
        return "sil"
    phn = phn.strip(" ")
    if phn in ("ERR", "err"):
        return "err"
    if phn in ("ER)", "ER0"):
        return "er0"
    if phn in ("AX", "ax", "AH)", "AH0"):
        return "ah0"
    if phn == "V``":
        return "v"
    if phn == "W`":
        return "w"
    return phn.lower()


def normalize_canonical_phone(mark: str, keep_reduced: bool = True) -> str:
    """Normalize a canonical (prompt-side) TextGrid mark to a model unit.

    Mirrors reference l2arctic_prep.py:117-143: strip stress digits except
    on AH0/ER0, then apply the special-token table.  With
    ``keep_reduced=False`` the reduced vowels fold into ah/er (the
    cnn-rnn-ctc 39-phone recipe, cnn-rnn-ctc/local/l2arctic_prep.py:76-79).
    """
    phn = mark if mark is not None else ""
    if phn in ("AH0", "ER0"):
        pass
    else:
        phn = phn.rstrip(string.digits)
    out = _normalize_common(phn)
    if not keep_reduced:
        out = {"ah0": "ah", "er0": "er"}.get(out, out)
    return out


def normalize_annotated_phone(mark: str, keep_reduced: bool = True) -> str:
    """Normalize an annotated (human actual-pronunciation) TextGrid mark.

    Mirrors reference l2arctic_prep.py:64-97: an annotation mark is
    "canonical,actual,type"; callers pass the actual field.  Stress digits
    and the */_ error decorations are stripped except on AH0/ER0.
    """
    phn = mark if mark is not None else ""
    if phn in ("AH0", "ER0"):
        pass
    else:
        phn = phn.rstrip(string.digits + "*_")
    out = _normalize_common(phn)
    if not keep_reduced:
        out = {"ah0": "ah", "er0": "er"}.get(out, out)
    return out


def del_repeat_sil(phones: list[str]) -> list[str]:
    """Collapse consecutive sil tokens (reference l2arctic_prep.py:33-40)."""
    if not phones:
        return []
    out = [phones[0]]
    for p in phones[1:]:
        if p == "sil" and out[-1] == "sil":
            continue
        out.append(p)
    return out


def strip_stress(phone: str) -> str:
    """Strip stress digits from an uppercase CMU phone except AH0/ER0
    (reference infer.py:549)."""
    if phone in ("ER0", "AH0"):
        return phone
    return phone.rstrip(string.digits)
