"""Phonetic dictionary: word -> CMU phones / IPA, translation, phonics
(counterpart of mdd_tpu/lexicon/dictionary.py, with the same tables, rules
and answers).

Redesign of the reference's dict/phonetic_dict.py (class Phonetic,
:19-570) without its mandatory runtime dependencies (espeak phonemizer,
g2p_en, melo TTS).  The canonical-phoneme source hierarchy is:

  1. the espeak phonemizer (import-gated: `phonemizer` + the espeak
     library), preferred when present exactly like the reference's
     "return the phonemizer output" policy (phonetic_dict.py:481-498) —
     see espeak_ipa/espeak_phones;
  2. the IPA CMUdict (cmudict-0.7b-ipa.txt) converted through the same
     IPA->CMU39+AH0/ER0 rules — the offline stand-in for (1);
  3. plain CMUdict (cmudict.dict) lookup;
  4. a rule-based fallback G2P for out-of-vocabulary words;
with g2p_en likewise import-gated into g2p(), and every present backend
cross-checked with a disagreement warning like the reference.

Data assets are the public-domain CMUdict files (plus the optional
phonics_engine.csv and an ECDICT csv); they are data, not code, and are
not vendored.  Their directory is the constructor's `asset_dir` or the
MDD_DICT_DIR environment variable, and nothing else: unlike mdd_tpu, the
port has no built-in fallback directory (see default_asset_dir).
"""

from __future__ import annotations

import csv
import os
import re
import string
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# CMU -> IPA display mapping ("US syllable way", phonetic_dict.py:21-64).
CMU_TO_IPA_WIKI: Dict[str, str] = {
    "AA": "a", "AE": "æ", "AH0": "ə", "AH": "ʌ", "AO": "ɔ", "AW": "aʊ",
    "AY": "aɪ", "EH": "e", "ER": "ɜ", "ER0": "ər", "EY": "eɪ", "IH": "ɪ",
    "IY": "i", "OW": "oʊ", "OY": "ɔɪ", "UH": "ʊ", "UW": "u",
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "F": "f", "G": "g",
    "HH": "h", "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n",
    "NG": "ŋ", "P": "p", "R": "r", "S": "s", "SH": "ʃ", "T": "t",
    "TH": "θ", "V": "v", "W": "w", "Y": "j", "Z": "z", "ZH": "ʒ",
}
IPA_TO_CMU_WIKI = {v: k for k, v in CMU_TO_IPA_WIKI.items()}

CMU_VOWELS = ["AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH",
              "IY", "OW", "OY", "UH", "UW", "AH0", "ER0"]
CMU_CONSONANTS = ["B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L",
                  "M", "N", "NG", "P", "R", "S", "SH", "T", "TH", "V",
                  "W", "Y", "Z", "ZH"]
IPA_VOWELS = [CMU_TO_IPA_WIKI[p] for p in CMU_VOWELS if p != "ER0"]


def default_asset_dir() -> Optional[str]:
    """MDD_DICT_DIR when it names a directory, else None.

    mdd_tpu's version falls back to a fixed mount of the reference
    project's dictionary directory; the port does not, so an engine
    without MDD_DICT_DIR or an explicit asset_dir fails at construction
    (validate_assets) wherever it runs."""
    env = os.environ.get("MDD_DICT_DIR")
    if env and os.path.isdir(env):
        return env
    return None


# ---------------------------------------------------------------------------
# IPA normalization (phonetic_dict.py:250-314 semantics)
# ---------------------------------------------------------------------------

_CHAR_SUBS_COMMON = [("ɹ", "r"), ("ɚr", "ər"), ("ɚˈr", "ər"), ("ɚ", "ər"),
                     ("ɛ", "e"), ("ɐ", "ə"), ("ᵻ", "ɪ"), ("ɡ", "g")]
_CHAR_SUBS_TAIL = [("ɾ", "t"), ("ɝ", "ɜ"), ("iə", "ɪə")]


def character_normalize(phonetic: str, style: str = "us") -> str:
    """Fold espeak/phonemizer IPA variants onto the wiki symbol set."""
    for a, b in _CHAR_SUBS_COMMON:
        phonetic = phonetic.replace(a, b)
    if style == "us":
        phonetic = phonetic.replace("ɑ", "a")
    elif style == "br":
        phonetic = phonetic.replace("a", "æ")
        phonetic = phonetic.replace("æʊ", "aʊ")
        phonetic = phonetic.replace("æɪ", "aɪ")
        phonetic = phonetic.replace("ɑ", "a")
    for a, b in _CHAR_SUBS_TAIL:
        phonetic = phonetic.replace(a, b)
    return phonetic


def stress_normalize(phonetic: str) -> str:
    """Move/drop the primary-stress mark (phonetic_dict.py:250-279):
    drop it at the edges or before the first vowel; otherwise shift it
    before the onset consonant (with an 'st' cluster special case)."""
    index = phonetic.find("ˈ")
    if index == -1 or len(phonetic) == 0:
        return phonetic
    if index == 0:
        return phonetic[1:]
    if index == len(phonetic) - 1:
        return phonetic[:index]
    is_first_vowel = not any(v in phonetic[:index] for v in IPA_VOWELS)
    if is_first_vowel:
        return phonetic[:index] + phonetic[index + 1:]
    if phonetic[index - 1] in IPA_VOWELS:
        return phonetic
    if index >= 2 and phonetic[index - 2:index] in IPA_VOWELS:
        return phonetic
    if index >= 2 and phonetic[index - 2:index] == "st":
        return phonetic[:index - 2] + "ˈst" + phonetic[index + 1:]
    return (phonetic[:index - 1] + "ˈ" + phonetic[index - 1]
            + phonetic[index + 1:])


def ipa_normalize(phonetic: str, style: str = "us") -> str:
    phonetic = character_normalize(phonetic, style)
    phonetic = phonetic.replace("ˌ", "")
    return stress_normalize(phonetic)


def ipa_to_phones39(phonetic: str) -> List[str]:
    """IPA string -> CMU39+AH0/ER0 phones with stress digits
    (phonetic_dict.py:316-364): longest-match (2-char first) against the
    wiki table; vowels get a stress digit — '1'/'2' from a preceding
    stress mark, else '0'; AH0/ER0 carry their own digit."""
    phonetic = character_normalize(phonetic)
    phonetic = phonetic.replace("ː", "")
    stress_map = {"ˌ": "2", "ˈ": "1"}
    phones: List[str] = []
    i = 0
    while i < len(phonetic):
        ch = phonetic[i]
        if ch in stress_map:
            if i + 3 <= len(phonetic) and phonetic[i + 1:i + 3] in IPA_TO_CMU_WIKI:
                phones.append(IPA_TO_CMU_WIKI[phonetic[i + 1:i + 3]]
                              + stress_map[ch])
                i += 3
            elif i + 2 <= len(phonetic) and phonetic[i + 1] in IPA_TO_CMU_WIKI:
                phones.append(IPA_TO_CMU_WIKI[phonetic[i + 1]]
                              + stress_map[ch])
                i += 2
            else:
                i += 1
            continue
        if i + 2 <= len(phonetic) and phonetic[i:i + 2] in IPA_TO_CMU_WIKI:
            p = IPA_TO_CMU_WIKI[phonetic[i:i + 2]]
            if p in CMU_VOWELS and p != "ER0":
                phones.append(p + "0")
            else:
                phones.append(p)
            i += 2
            continue
        p = IPA_TO_CMU_WIKI.get(ch)
        if p is None:
            pass
        elif p == "AH0":
            phones.append(p)
        elif p in CMU_VOWELS:
            phones.append(p + "0")
        else:
            phones.append(p)
        i += 1
    return phones


def phones39_to_ipa(phones: List[str], stress: bool = True) -> List[str]:
    """CMU phones (with stress digits) -> IPA symbols, inserting a primary
    stress mark before the stressed syllable's onset
    (phonetic_dict.py:367-396)."""
    phones = list(phones)
    if stress:
        vowels = [(i, p) for i, p in enumerate(phones)
                  if p not in CMU_CONSONANTS]
        if vowels:
            i = 0
            while i < len(vowels):
                if len(vowels[i][1]) > 2 and vowels[i][1][2] == "1":
                    break
                i += 1
            if 0 < i < len(vowels):
                index = vowels[i][0] - 1
                if (phones[index] == "T" and index - 1 >= 0
                        and phones[index - 1] == "S"):
                    phones.insert(index - 1, "ˈ")
                elif phones[index].rstrip(string.digits) in CMU_VOWELS:
                    phones.insert(index + 1, "ˈ")
                else:
                    phones.insert(index, "ˈ")
    phones = [p.rstrip(string.digits) if p != "AH0" else p for p in phones]
    return [CMU_TO_IPA_WIKI.get(p, p) for p in phones]


def strip_stress_keep_reduced(phones: List[str]) -> List[str]:
    """Strip stress digits except on ER0/AH0 (infer.py:549)."""
    return [p if p in ("ER0", "AH0") else p.rstrip(string.digits)
            for p in phones]


# ---------------------------------------------------------------------------
# Rule-based fallback G2P (OOV words only)
# ---------------------------------------------------------------------------

_FALLBACK_RULES: List[Tuple[str, List[str]]] = [
    ("tion", ["SH", "AH0", "N"]), ("sion", ["ZH", "AH0", "N"]),
    ("ough", ["AO0"]), ("augh", ["AO0"]), ("eigh", ["EY0"]),
    ("igh", ["AY0"]), ("tch", ["CH"]), ("dge", ["JH"]),
    ("sch", ["S", "K"]), ("ing", ["IH0", "NG"]),
    ("ch", ["CH"]), ("ck", ["K"]), ("sh", ["SH"]), ("th", ["TH"]),
    ("ph", ["F"]), ("wh", ["W"]), ("ng", ["NG"]), ("qu", ["K", "W"]),
    ("oo", ["UW0"]), ("ee", ["IY0"]), ("ea", ["IY0"]), ("ai", ["EY0"]),
    ("ay", ["EY0"]), ("oa", ["OW0"]), ("ou", ["AW0"]), ("ow", ["OW0"]),
    ("oi", ["OY0"]), ("oy", ["OY0"]), ("au", ["AO0"]), ("aw", ["AO0"]),
    ("ar", ["AA0", "R"]), ("er", ["ER0"]), ("ir", ["ER0"]),
    ("or", ["AO0", "R"]), ("ur", ["ER0"]),
    ("a", ["AE0"]), ("b", ["B"]), ("c", ["K"]), ("d", ["D"]),
    ("e", ["EH0"]), ("f", ["F"]), ("g", ["G"]), ("h", ["HH"]),
    ("i", ["IH0"]), ("j", ["JH"]), ("k", ["K"]), ("l", ["L"]),
    ("m", ["M"]), ("n", ["N"]), ("o", ["AA0"]), ("p", ["P"]),
    ("q", ["K"]), ("r", ["R"]), ("s", ["S"]), ("t", ["T"]),
    ("u", ["AH1"]), ("v", ["V"]), ("w", ["W"]), ("x", ["K", "S"]),
    ("y", ["Y"]), ("z", ["Z"]),
]


def fallback_g2p(word: str) -> List[str]:
    """Greedy longest-match orthographic G2P for OOV words.  A coarse
    stand-in for the reference's g2p_en neural backend; real words should
    come from the dictionaries."""
    word = re.sub(r"[^a-z]", "", word.lower())
    phones: List[str] = []
    i = 0
    while i < len(word):
        # silent final e
        if word[i] == "e" and i == len(word) - 1 and len(word) > 2:
            break
        for pat, ph in _FALLBACK_RULES:
            if word.startswith(pat, i):
                phones += ph
                i += len(pat)
                break
        else:
            i += 1
    return phones


# ---------------------------------------------------------------------------
# The dictionary facade
# ---------------------------------------------------------------------------

class Phonetic:
    """Word-level pronunciation/translation oracle (espeak-free).

    API mirrors the reference Phonetic class where it matters to the
    inference pipeline: cmu_dict, ipa_dict, g2p, api_word_phonetic,
    api_word_phones_cmu, api_word_translation, canonical_model_phones.
    """

    def __init__(self, asset_dir: Optional[str] = None,
                 ecdict_csv: Optional[str] = None):
        self.asset_dir = asset_dir or default_asset_dir()
        self.ecdict_csv = ecdict_csv
        self.cmudict_plain: Dict[str, List[str]] = {}
        self.cmudict_ipa: Dict[str, List[str]] = {}
        self.letter_ipa_dict: Dict[str, dict] = {}
        self._ecdict: Dict[str, dict] = {}
        self._g2p_en = None       # optional backend (g2p_en)
        self._phonemizer = None   # optional backend (phonemizer/espeak)

    def validate_assets(self) -> None:
        """Eagerly verify the core dictionary assets exist.

        Raises FileNotFoundError with setup guidance if the asset dir is
        unset or the CMUdict files are missing — callers that will need
        G2P (the inference engine) should fail at construction, not at
        the first word lookup."""
        required = ("cmudict.dict", "cmudict-0.7b-ipa.txt")
        if not self.asset_dir:
            raise FileNotFoundError(
                "dictionary asset dir not configured: set MDD_DICT_DIR "
                "or pass asset_dir= (need the public-domain CMUdict "
                f"files {', '.join(required)})")
        missing = [n for n in required
                   if not os.path.exists(os.path.join(self.asset_dir, n))]
        if missing:
            raise FileNotFoundError(
                f"dictionary assets missing from {self.asset_dir}: "
                f"{', '.join(missing)} (public-domain CMUdict files; "
                "point MDD_DICT_DIR at a directory containing them)")

    # -- loaders (lazy, reference :110-166) --------------------------------
    def _asset(self, name: str) -> str:
        if not self.asset_dir:
            raise FileNotFoundError(
                f"dictionary asset dir not configured (need {name}); set "
                "MDD_DICT_DIR or pass asset_dir=")
        return os.path.join(self.asset_dir, name)

    def load_cmudict(self, reload: bool = False) -> None:
        if self.cmudict_plain and not reload:
            return
        with open(self._asset("cmudict.dict"), "r", encoding="utf-8",
                  errors="replace") as f:
            for line in f:
                parts = [p.strip() for p in line.split(" ")]
                if parts:
                    self.cmudict_plain[parts[0].lower()] = parts[1:]

    def load_ipadict(self, reload: bool = False) -> None:
        if self.cmudict_ipa and not reload:
            return
        with open(self._asset("cmudict-0.7b-ipa.txt"), "r",
                  encoding="utf-8", errors="replace") as f:
            for line in f:
                parts = [p.strip() for p in line.split("\t")]
                if len(parts) < 2:
                    continue
                self.cmudict_ipa[parts[0].lower()] = [
                    p.strip(" ˈˌ") for p in parts[1].split(",")]

    def load_letter_ipa_dict(self, reload: bool = False) -> None:
        """Letter-to-IPA phonics table (phonics_engine.csv: word, ?,
        dotted IPA, letter-group-to-IPA mapping)."""
        if self.letter_ipa_dict and not reload:
            return
        with open(self._asset("phonics_engine.csv"), newline="",
                  encoding="utf-8", errors="replace") as f:
            for row in csv.reader(f, delimiter="\t", quotechar="|"):
                if len(row) < 4:
                    continue
                mapping = [tuple(p.split("-")) for p in row[3].split(",")]
                self.letter_ipa_dict[row[0]] = {
                    "phonetic": row[2].replace(".", ""),
                    "mapping": mapping,
                }

    def load_ecdict(self, reload: bool = False) -> None:
        """English->Chinese dictionary (ECDICT csv: word,phonetic,...,
        translation,...).  Optional: silently empty when no csv given."""
        if self._ecdict and not reload:
            return
        if not self.ecdict_csv or not os.path.exists(self.ecdict_csv):
            return
        with open(self.ecdict_csv, newline="", encoding="utf-8",
                  errors="replace") as f:
            reader = csv.DictReader(f)
            for row in reader:
                self._ecdict[row.get("word", "").lower()] = row

    # -- lookups ------------------------------------------------------------
    def cmu_dict(self, word: str, to_ipa: bool = False) -> Optional[str]:
        self.load_cmudict()
        phones = self.cmudict_plain.get(word.lower())
        if not phones:
            return None
        if to_ipa:
            return "".join(phones39_to_ipa(phones, True))
        return " ".join(phones)

    def ipa_dict(self, word: str, index: int = 0) -> Optional[str]:
        self.load_ipadict()
        phonetics = self.cmudict_ipa.get(word.lower())
        if not phonetics:
            return None
        if index >= len(phonetics):
            warnings.warn(f"Word {word} only found {len(phonetics)} "
                          "in dictionary.")
            index = 0
        return phonetics[index]

    def g2p(self, word: str, to_ipa: bool = False) -> str:
        """Best-available G2P: g2p_en when importable, else IPA-dict
        conversion, else CMUdict, else the rule fallback."""
        if self._g2p_en is None:
            try:
                from g2p_en import G2p  # optional
                self._g2p_en = G2p()
            except Exception:
                self._g2p_en = False
        if self._g2p_en:
            phones = [p for p in self._g2p_en(word) if p.strip()]
        else:
            ipa = self.ipa_dict(word)
            if ipa is not None:
                phones = ipa_to_phones39(ipa)
            else:
                cmu = self.cmu_dict(word)
                phones = cmu.split(" ") if cmu else fallback_g2p(word)
        if to_ipa:
            return "".join(phones39_to_ipa(phones, True))
        return " ".join(phones)

    def espeak_ipa(self, word: str, style: str = "us") -> Optional[str]:
        """Normalized IPA from the espeak backend via `phonemizer`, when
        the package (and the espeak library it wraps) is importable —
        the reference's primary backend (phonetic_dict.py:414-441).
        Returns None when unavailable (the IPA-CMUdict conversion then
        substitutes, see api_word_phones_cmu)."""
        if self._phonemizer is None:
            try:
                from phonemizer.backend import EspeakBackend  # optional

                self._phonemizer = {
                    "us": EspeakBackend("en-us", with_stress=True),
                    "br": EspeakBackend("en-gb", with_stress=True),
                }
            except Exception:
                self._phonemizer = False
        if not self._phonemizer:
            return None
        out = self._phonemizer[style].phonemize([word.strip()], strip=True)
        return ipa_normalize(out[0].strip(), style)

    def espeak_phones(self, word: str) -> Optional[str]:
        """espeak IPA -> CMU39+AH0/ER0 phones (phonetic_dict.py:414-441
        composed with :316-364), or None when the backend is absent."""
        ipa = self.espeak_ipa(word)
        return " ".join(ipa_to_phones39(ipa)) if ipa is not None else None

    # -- API surface (reference :468-570) -----------------------------------
    def api_word_phones_cmu(self, word: str) -> str:
        """Canonical CMU phones with the reference's cross-check policy
        (phonetic_dict.py:481-498): consult CMUdict, the IPA-CMUdict
        conversion and — when the import-gated backend is available —
        the espeak phonemizer; warn on disagreement; return the
        phonemizer output when present (the reference's preference),
        else the IPA-derived answer (its closest offline stand-in: both
        are IPA routed through the same _ipa_to_phones39 rules)."""
        word = word.strip()
        p1 = self.cmu_dict(word)
        p2 = self.espeak_phones(word)
        ipa = self.ipa_dict(word)
        p3 = " ".join(ipa_to_phones39(ipa)) if ipa is not None else None
        present = [p for p in (p1, p2, p3) if p]
        if len(set(present)) > 1:
            warnings.warn(
                f"G2P backends disagree for word {word}: {present}.")
        if p2:
            return p2
        if p3:
            return p3
        if p1:
            return p1
        warnings.warn(
            f"word '{word}' not in any dictionary backend; using the "
            "rule-based fallback G2P (coarse canonicals — expect lower "
            "diagnosis quality for this word)")
        return " ".join(fallback_g2p(word))

    def api_word_phonetic(self, word: str) -> str:
        """Display IPA, 英/美 format (reference :468-472).  Uses the
        espeak backend per accent when importable; without it the
        British variant is derived from the US IPA-dict entry by the
        reference's br character rules."""
        word = word.strip()
        es_us, es_br = self.espeak_ipa(word, "us"), self.espeak_ipa(word, "br")
        if es_us and es_br:
            return f"英: /{es_br}/ 美: /{es_us}/ "
        us = self.ipa_dict(word)
        if us is None:
            us = "".join(phones39_to_ipa(
                self.api_word_phones_cmu(word).split(" "), True))
        us_norm = ipa_normalize(us, "us")
        br_norm = ipa_normalize(us, "br")
        return f"英: /{br_norm}/ 美: /{us_norm}/ "

    def canonical_model_phones(self, word: str) -> List[str]:
        """Lower-case model units for the acoustic model's text branch
        (infer.py:548-552): stress stripped except AH0/ER0."""
        phones = self.api_word_phones_cmu(word).split(" ")
        return [p.lower() for p in strip_stress_keep_reduced(phones) if p]

    def word_ipa_display(self, word: str) -> List[str]:
        """Per-phone IPA symbols matching canonical_model_phones
        (infer.py:553-554)."""
        phones = strip_stress_keep_reduced(
            self.api_word_phones_cmu(word).split(" "))
        return [CMU_TO_IPA_WIKI.get(p, p) for p in phones if p]

    def api_word_phonics(self, word: str) -> Optional[Dict]:
        """Letter-group -> IPA phonics breakdown from phonics_engine.csv
        (the reference loads this table in its dictionary exercise,
        phonetic_dict.py:147-166, 579).  Returns {'phonetic': ipa,
        'mapping': [(letters, ipa), ...]} or None when the word is not in
        the phonics table."""
        try:
            self.load_letter_ipa_dict()
        except FileNotFoundError:
            return None
        word = word.strip()
        for key in (word, word.lower(), word.capitalize(), word.upper()):
            if key in self.letter_ipa_dict:
                return self.letter_ipa_dict[key]
        return None

    def api_word_phrase_tts(self, text: str, accent: str = "Default",
                            speed: float = 0.7,
                            out_dir: str = ".") -> Optional[str]:
        """Text-to-speech via melo when importable (reference
        phonetic_dict.py:504-552 — unused by the demo there too).
        Returns the wav path, or None when the backend is unavailable."""
        assert accent in ("Default", "US", "BR", "AU", "IN")
        try:
            from melo.api import TTS  # optional heavy dependency
        except Exception:
            warnings.warn("melo TTS backend unavailable; skipping TTS")
            return None
        model = TTS(language="EN", device="cpu")
        speaker_ids = model.hps.data.spk2id
        naming = "_".join(p.lower() for p in text.strip().split(" ")[:3])
        out = os.path.join(out_dir, f"{naming}.wav")
        model.tts_to_file(text.strip(), speaker_ids[f"EN-{accent}"], out,
                          speed=speed)
        return out

    def api_word_translation(self, word: str) -> str:
        """Chinese translation from ECDICT, filtered to headline word
        classes (reference :191-238); '' when unavailable."""
        self.load_ecdict()
        entry = self._ecdict.get(word.strip().lower())
        if not entry:
            return ""
        texts = entry.get("translation", "") or ""
        first_classes = ["n.", "v.", "vt.", "vi.", "a.", "adj.", "adv.",
                         "prep.", "conj.", "pron.", "num."]
        filtered = []
        for t in texts.split("\\n"):
            c = t.split(" ")[0]
            if c in first_classes:
                filtered.append("adj." + t[2:] if c == "a." else t)
        return "\n".join(filtered).strip() if filtered else texts.strip()
