"""Port lexicon vs mdd_tpu's: the phone tables and normalizers, the TIMIT
maps, the IPA rules and the fallback G2P on the cases of
tests/test_dictionary.py plus ~200 seeded strings each, and `Phonetic`
(every lookup, its answer and its warnings) on a small dictionary written
here: the real CMUdict, phonics and ECDICT files are not in the
repository.  Strings must match exactly."""

import warnings

import numpy as np
import pytest

import mdd_tpu.lexicon as jax_lexicon
import mdd_tpu.lexicon.dictionary as jax_dictionary
import mdd_tpu.lexicon.phones as jax_phones
import mdd_tpu.lexicon.timit as jax_timit
import mdd_tpu_torch.lexicon as lexicon
import mdd_tpu_torch.lexicon.dictionary as dictionary
import mdd_tpu_torch.lexicon.phones as phones
import mdd_tpu_torch.lexicon.timit as timit

# CMUdict entries (public domain) of the words the tests and the smoke use;
# "tomato" and "read" have two pronunciations, "gather" only a plain entry
CMUDICT = """\
about AH0 B AW1 T
accept AE0 K S EH1 P T
accept(2) AH0 K S EH1 P T
bananas B AH0 N AE1 N AH0 Z
gather G AE1 DH ER0
magazine M AE1 G AH0 Z IY2 N
read R EH1 D
read(2) R IY1 D
talked T AO1 K T
through TH R UW1
tomato T AH0 M EY1 T OW2
vocabulary V OW0 K AE1 B Y AH0 L EH2 R IY0
cat K AE1 T
ship SH IH1 P
"""
CMUDICT_IPA = """\
ABOUT\təˈbaʊt
ACCEPT\tækˈsɛpt, əkˈsɛpt
BANANAS\tbəˈnænəz
MAGAZINE\tˈmæɡəˌzin, ˌmæɡəˈzin
READ\tˈrɛd, ˈrid
TALKED\tˈtɔkt
THROUGH\tˈθru
TOMATO\ttəˈmeɪˌtoʊ, təˈmɑˌtoʊ
VOCABULARY\tvoʊˈkæbjəˌlɛri
CAT\tˈkæt
SHIP\tˈʃɪp
CHEESE\tˈtʃiz
"""
# word, frequency, dotted IPA, letter-group -> IPA mapping (tab separated)
PHONICS = """\
African\t1\tˈæf.rɪ.kən\ta-æ,f-f,r-r,i-ɪ,c-k,a-ə,n-n
about\t2\tə.ˈbaʊt\ta-ə,b-b,ou-aʊ,t-t
gather\t3\tˈgæ.ðər\tg-g,a-æ,th-ð,er-ər
Through\t4\tθru\tth-θ,r-r,ough-u
short\t5
"""
ECDICT = """\
word,phonetic,definition,translation
gather,'gæðə,v. collect,v. 聚集；收集
vocabulary,və'kæbjuləri,n. words,n. 词汇；单词表
about,ə'baut,adv. around,adv. 大约\\nprep. 关于
magazine,mægə'zi:n,n. periodical,n. 杂志；弹仓
through,θru:,prep. via,prep. 通过\\nadv. 从头到尾\\n[网络] 穿过
talked,tɔ:kt,,v. 说话（talk的过去式）
oddity,,,网络释义 only
"""
# prompt words: every table's entries, a plain-only word, an IPA-only word,
# case and space variants, and words no dictionary holds
WORDS = ["about", "accept", "bananas", "gather", "magazine", "read",
         "talked", "through", "tomato", "vocabulary", "cat", "ship",
         "cheese", "African", "ABOUT", " Gather ", "oddity", "blorptastic",
         "zxqj", "knight", "a"]


def write_dictionary(root, phonics: bool = True, ecdict: bool = True):
    """The lexicon's files under root -> (asset_dir, ecdict_csv or None)."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "cmudict.dict").write_text(CMUDICT, encoding="utf-8")
    (root / "cmudict-0.7b-ipa.txt").write_text(CMUDICT_IPA, encoding="utf-8")
    if phonics:
        (root / "phonics_engine.csv").write_text(PHONICS, encoding="utf-8")
    csv_path = None
    if ecdict:
        csv_path = root / "ecdict.csv"
        csv_path.write_text(ECDICT, encoding="utf-8")
    return str(root), (str(csv_path) if csv_path else None)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module,name", [
    ("phones", n) for n in ("CANONICAL_UNITS_41", "CANONICAL_UNITS_43",
                            "CMU39", "VOWELS", "CONSONANTS", "CMU_TO_IPA",
                            "IPA_TO_CMU")] + [
    ("timit", n) for n in ("TIMIT_60_48", "TIMIT_60_41", "TIMIT_48_39")] + [
    ("dictionary", n) for n in ("CMU_TO_IPA_WIKI", "IPA_TO_CMU_WIKI",
                                "CMU_VOWELS", "CMU_CONSONANTS", "IPA_VOWELS",
                                "_FALLBACK_RULES")])
def test_tables_equal(module, name):
    ours = getattr({"phones": phones, "timit": timit,
                    "dictionary": dictionary}[module], name)
    ref = getattr({"phones": jax_phones, "timit": jax_timit,
                   "dictionary": jax_dictionary}[module], name)
    assert ours == ref
    assert type(ours) is type(ref)


def test_package_reexports_match():
    names = [n for n in dir(jax_lexicon) if not n.startswith("_")
             and n not in ("phones", "timit", "dictionary")]
    assert names
    for n in names:
        ours, ref = getattr(lexicon, n), getattr(jax_lexicon, n)
        if callable(ref):   # functions: the same one of the port's modules
            assert ours.__name__ == ref.__name__, n
            assert ours.__module__ == ref.__module__.replace(
                "mdd_tpu.", "mdd_tpu_torch.", 1), n
        else:
            assert ours == ref, n


def test_augment_uses_the_lexicon_phone_classes():
    from mdd_tpu_torch.frontend import augment

    assert augment.VOWELS is phones.VOWELS
    assert augment.CONSONANTS is phones.CONSONANTS


# ---------------------------------------------------------------------------
# string functions on the known cases and on seeded strings
# ---------------------------------------------------------------------------

IPA_SYMBOLS = sorted(set("".join(dictionary.CMU_TO_IPA_WIKI.values()))
                     | set("ɹɚɛɐᵻɡɑɾɝːˈˌ ") | set("aeiourstnlbd"))
MARK_PIECES = (list(dictionary.CMU_TO_IPA_WIKI) + [
    "sp", "SIL", "spn", "ERR", "err", "ER)", "AH)", "AX", "ax", "V``", "W`",
    "", " ", "0", "1", "2", "*", "_", "aa", "hh"])

# tests/test_dictionary.py's inputs first
KNOWN_IPA = ["ɹɛd", "bɚd", "ɡɑt", "haʊs", "ˈæpl", "əˈbaʊt", "bəˈnænə",
             "grˈeɪt", "kæt", "tʃiz", "ər", "iː", "", "ˈ", "aˈ", "stˈa",
             "əsˈtɑp", "ˌɛksˈtɹə"]


def _ipa_strings(n=200, seed=0):
    rng = np.random.default_rng(seed)
    out = list(KNOWN_IPA)
    for _ in range(n):
        k = int(rng.integers(0, 13))
        out.append("".join(IPA_SYMBOLS[i]
                           for i in rng.integers(0, len(IPA_SYMBOLS), k)))
    return out


def _marks(n=200, seed=1):
    rng = np.random.default_rng(seed)
    out = list(MARK_PIECES) + ["AH0", "ER0", "AA2*", "HH1", "L OW1",
                               "AH0,AA,s", None]
    for _ in range(n):
        k = int(rng.integers(1, 4))
        out.append("".join(MARK_PIECES[i]
                           for i in rng.integers(0, len(MARK_PIECES), k)))
    return out


def _cmu_lists(n=200, seed=2):
    rng = np.random.default_rng(seed)
    base = dictionary.CMU_VOWELS + dictionary.CMU_CONSONANTS
    out = [["K", "AE1", "T"], ["AH0", "B", "AW1", "T"], ["S", "T", "AA1", "P"],
           ["AE1", "AH0", "ER0", "T"], ["IY1"], [], ["EH1", "S", "T", "IY0"]]
    for _ in range(n):
        lst = []
        for i in rng.integers(0, len(base), int(rng.integers(0, 9))):
            p = base[i]
            if p in dictionary.CMU_VOWELS and p not in ("AH0", "ER0"):
                p += ["", "0", "1", "2"][int(rng.integers(0, 4))]
            lst.append(p)
        out.append(lst)
    return out


def _words(n=200, seed=3):
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz") + list("ABZ-' 1")
    out = ["zxqj", "blorptastic", "a", "", "ship", "church", "nation",
           "vision", "through", "knight", "cake", "be", "queue"]
    for _ in range(n):
        k = int(rng.integers(0, 12))
        out.append("".join(letters[i] for i in rng.integers(0, len(letters), k)))
    return out


@pytest.mark.parametrize("style", ["us", "br", "au"])
def test_character_normalize(style):
    for s in _ipa_strings():
        assert (dictionary.character_normalize(s, style)
                == jax_dictionary.character_normalize(s, style)), s


@pytest.mark.parametrize("name", ["stress_normalize", "ipa_to_phones39"])
def test_ipa_string_rules(name):
    ours, ref = getattr(dictionary, name), getattr(jax_dictionary, name)
    for s in _ipa_strings():
        assert ours(s) == ref(s), s


@pytest.mark.parametrize("style", ["us", "br"])
def test_ipa_normalize(style):
    for s in _ipa_strings(seed=4):
        assert (dictionary.ipa_normalize(s, style)
                == jax_dictionary.ipa_normalize(s, style)), s


@pytest.mark.parametrize("stress", [True, False])
def test_phones39_to_ipa(stress):
    for lst in _cmu_lists():
        assert (dictionary.phones39_to_ipa(lst, stress)
                == jax_dictionary.phones39_to_ipa(lst, stress)), lst


def test_strip_stress():
    for lst in _cmu_lists(seed=5):
        assert (dictionary.strip_stress_keep_reduced(lst)
                == jax_dictionary.strip_stress_keep_reduced(lst))
        for p in lst:
            assert phones.strip_stress(p) == jax_phones.strip_stress(p)


def test_fallback_g2p():
    for w in _words():
        assert dictionary.fallback_g2p(w) == jax_dictionary.fallback_g2p(w), w


@pytest.mark.parametrize("name", ["normalize_canonical_phone",
                                  "normalize_annotated_phone"])
@pytest.mark.parametrize("keep_reduced", [True, False])
def test_phone_normalizers(name, keep_reduced):
    ours, ref = getattr(phones, name), getattr(jax_phones, name)
    for m in _marks():
        assert ours(m, keep_reduced) == ref(m, keep_reduced), m


def test_del_repeat_sil():
    rng = np.random.default_rng(6)
    pool = ["sil", "sil", "aa", "b", "sil"]
    seqs = [[], ["sil"], ["sil", "sil"]] + [
        [pool[i] for i in rng.integers(0, len(pool), int(rng.integers(0, 10)))]
        for _ in range(100)]
    for seq in seqs:
        assert phones.del_repeat_sil(seq) == jax_phones.del_repeat_sil(seq)


@pytest.mark.parametrize("scheme", ["60-48", "60-41", "48-39"])
def test_map_timit_phones(scheme):
    rng = np.random.default_rng(7)
    pool = sorted(set(timit.TIMIT_60_48) | set(timit.TIMIT_48_39) | {"q", "xx"})
    for _ in range(50):
        seq = [pool[i] for i in rng.integers(0, len(pool), 12)]
        assert (timit.map_timit_phones(seq, scheme)
                == jax_timit.map_timit_phones(seq, scheme))


# ---------------------------------------------------------------------------
# Phonetic
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return write_dictionary(tmp_path_factory.mktemp("dict"))


def _recorded(fn, *args):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn(*args)
    return out, [str(w.message) for w in rec]


LOOKUPS = {
    "cmu_dict": lambda p, w: p.cmu_dict(w),
    "cmu_dict_ipa": lambda p, w: p.cmu_dict(w, to_ipa=True),
    "ipa_dict": lambda p, w: p.ipa_dict(w),
    "ipa_dict_second": lambda p, w: p.ipa_dict(w, 1),
    "ipa_dict_past_end": lambda p, w: p.ipa_dict(w, 5),
    "g2p": lambda p, w: p.g2p(w),
    "g2p_ipa": lambda p, w: p.g2p(w, to_ipa=True),
    "espeak_ipa": lambda p, w: p.espeak_ipa(w),
    "espeak_phones": lambda p, w: p.espeak_phones(w),
    "api_word_phones_cmu": lambda p, w: p.api_word_phones_cmu(w),
    "api_word_phonetic": lambda p, w: p.api_word_phonetic(w),
    "canonical_model_phones": lambda p, w: p.canonical_model_phones(w),
    "word_ipa_display": lambda p, w: p.word_ipa_display(w),
    "api_word_phonics": lambda p, w: p.api_word_phonics(w),
    "api_word_translation": lambda p, w: p.api_word_translation(w),
}


@pytest.mark.parametrize("lookup", sorted(LOOKUPS))
def test_phonetic_lookups_match(assets, lookup):
    """Every word, every lookup: the same answer and the same warnings."""
    asset_dir, csv_path = assets
    ours = dictionary.Phonetic(asset_dir=asset_dir, ecdict_csv=csv_path)
    ref = jax_dictionary.Phonetic(asset_dir=asset_dir, ecdict_csv=csv_path)
    fn = LOOKUPS[lookup]
    for w in WORDS:
        assert _recorded(fn, ours, w) == _recorded(fn, ref, w), (lookup, w)


def test_phonetic_tables_after_load(assets):
    asset_dir, csv_path = assets
    tabs = []
    for mod in (dictionary, jax_dictionary):
        p = mod.Phonetic(asset_dir=asset_dir, ecdict_csv=csv_path)
        p.load_cmudict()
        p.load_ipadict()
        p.load_letter_ipa_dict()
        p.load_ecdict()
        tabs.append((p.cmudict_plain, p.cmudict_ipa, p.letter_ipa_dict,
                     p._ecdict))
    assert tabs[0] == tabs[1]
    assert tabs[0][1]["tomato"] == ["təˈmeɪˌtoʊ", "təˈmɑˌtoʊ"]
    assert "short" not in tabs[0][2]   # a row without a mapping is skipped


def test_phonetic_known_answers(assets):
    """The answers mdd_tpu's tests pin, on this dictionary."""
    asset_dir, csv_path = assets
    p = dictionary.Phonetic(asset_dir=asset_dir, ecdict_csv=csv_path)
    assert p.cmu_dict("cat") == "K AE1 T"
    assert p.cmu_dict("zzzzxq") is None
    assert "æ" in p.ipa_dict("cat")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert p.canonical_model_phones("about") == ["ah0", "b", "aw", "t"]
        assert p.api_word_phonetic("about").startswith("英: /")
        assert p.canonical_model_phones("gather") == ["g", "ae", "dh", "er0"]
        assert p.canonical_model_phones("zxqj")    # the rule fallback
    assert p.api_word_translation("about") == "adv. 大约\nprep. 关于"
    entry = p.api_word_phonics("AFRICAN".capitalize())
    assert entry["phonetic"] == "ˈæfrɪkən" and ("a", "æ") in entry["mapping"]
    assert p.api_word_phonics("zzzznotaword") is None


def test_phonetic_without_optional_files(tmp_path):
    """No phonics table and no ECDICT: phonics None, translation '' in
    both packages; a missing ECDICT path is empty too."""
    asset_dir, _ = write_dictionary(tmp_path, phonics=False, ecdict=False)
    for mod in (dictionary, jax_dictionary):
        p = mod.Phonetic(asset_dir=asset_dir)
        assert p.api_word_phonics("about") is None
        assert p.api_word_translation("about") == ""
        q = mod.Phonetic(asset_dir=asset_dir,
                         ecdict_csv=str(tmp_path / "none.csv"))
        assert q.api_word_translation("gather") == ""


def _error(fn):
    try:
        fn()
    except FileNotFoundError as e:
        return str(e)
    return None


def test_validate_assets_errors(tmp_path):
    """The same errors, with the same guidance, from both packages: no
    directory, an empty one, one file missing; a complete one passes."""
    seen = {}
    for setup in ("unset", "empty", "no_ipa", "complete"):
        d = tmp_path / setup
        d.mkdir()
        if setup == "no_ipa":
            (d / "cmudict.dict").write_text(CMUDICT)
        if setup == "complete":
            write_dictionary(d)
        msgs = []
        for mod in (dictionary, jax_dictionary):
            p = mod.Phonetic(asset_dir=str(d))
            if setup == "unset":
                p.asset_dir = None
            msgs.append(_error(p.validate_assets))
        assert msgs[0] == msgs[1], setup
        seen[setup] = msgs[0]
    assert "MDD_DICT_DIR" in seen["unset"]
    assert "cmudict.dict, cmudict-0.7b-ipa.txt" in seen["empty"]
    assert seen["no_ipa"].endswith(
        "cmudict-0.7b-ipa.txt (public-domain CMUdict files; point "
        "MDD_DICT_DIR at a directory containing them)")
    assert seen["complete"] is None


def test_lookup_without_asset_dir_raises():
    for mod in (dictionary, jax_dictionary):
        p = mod.Phonetic()
        p.asset_dir = None
        with pytest.raises(FileNotFoundError, match="cmudict.dict"):
            p.cmu_dict("cat")
        assert p.api_word_phonics("cat") is None


def test_default_asset_dir_reads_only_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("MDD_DICT_DIR", str(tmp_path))
    assert dictionary.default_asset_dir() == str(tmp_path)
    assert jax_dictionary.default_asset_dir() == str(tmp_path)
    assert dictionary.Phonetic().asset_dir == str(tmp_path)
    monkeypatch.setenv("MDD_DICT_DIR", str(tmp_path / "missing"))
    assert dictionary.default_asset_dir() is None
    monkeypatch.delenv("MDD_DICT_DIR")
    assert dictionary.default_asset_dir() is None   # no built-in fallback
    with pytest.raises(FileNotFoundError, match="MDD_DICT_DIR"):
        dictionary.Phonetic().validate_assets()


def test_tts_backend_gated(tmp_path):
    """melo is absent: both packages warn and return None."""
    outs = [_recorded(mod.Phonetic().api_word_phrase_tts, "hello there",
                      "US", 0.7, str(tmp_path))
            for mod in (dictionary, jax_dictionary)]
    assert outs[0] == outs[1]
    assert outs[0][0] is None
