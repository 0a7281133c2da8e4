"""Lexicon: phone inventories, TIMIT maps, and the word -> phones / IPA /
translation / phonics dictionary (counterpart of mdd_tpu/lexicon)."""

from mdd_tpu_torch.lexicon.phones import (
    CMU39,
    VOWELS,
    CONSONANTS,
    CANONICAL_UNITS_41,
    CANONICAL_UNITS_43,
    CMU_TO_IPA,
    IPA_TO_CMU,
    normalize_annotated_phone,
    normalize_canonical_phone,
)
from mdd_tpu_torch.lexicon.timit import TIMIT_60_48, TIMIT_60_41, TIMIT_48_39, map_timit_phones
