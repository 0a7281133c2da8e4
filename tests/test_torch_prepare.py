"""Port data prep and TextGrid reader vs mdd_tpu's: both TextGrid formats
(interval and point tiers), prepare_l2arctic (both keep_reduced, every
split), prepare_timit (60-41, 60-48, speaker lists), split_timit_speakers,
merge_data_dirs and build_units on the fixture trees of
tests/test_prepare.py, rebuilt here with more speakers and utterances.
Every written file must be equal byte for byte; the four CLI subcommands
write what the functions write."""

import filecmp
import textwrap

import pytest

from mdd_tpu.data import prepare as jax_prepare
from mdd_tpu.data.textgrid import TextGrid as JaxTextGrid
from mdd_tpu_torch import cli
from mdd_tpu_torch.data import prepare
from mdd_tpu_torch.data.textgrid import TextGrid


def textgrid_long(tiers, point_tier=None) -> str:
    """A long-format TextGrid: tiers = [(name, [(xmin, xmax, mark)])];
    `point_tier` (name, [(time, mark)]) adds a TextTier."""
    items = []
    for k, (name, ivs) in enumerate(tiers, 1):
        body = "".join(
            f'        intervals [{i}]:\n            xmin = {a}\n'
            f'            xmax = {b}\n            text = "{m}"\n'
            for i, (a, b, m) in enumerate(ivs, 1))
        items.append(
            f'    item [{k}]:\n        class = "IntervalTier"\n'
            f'        name = "{name}"\n        xmin = 0\n        xmax = 1.0\n'
            f'        intervals: size = {len(ivs)}\n' + body)
    if point_tier is not None:
        name, pts = point_tier
        body = "".join(
            f'        points [{i}]:\n            number = {t}\n'
            f'            mark = "{m}"\n' for i, (t, m) in enumerate(pts, 1))
        items.append(
            f'    item [{len(items) + 1}]:\n        class = "TextTier"\n'
            f'        name = "{name}"\n        xmin = 0\n        xmax = 1.0\n'
            f'        points: size = {len(pts)}\n' + body)
    return ('File type = "ooTextFile"\nObject class = "TextGrid"\n\n'
            f'xmin = 0\nxmax = 1.0\ntiers? <exists>\nsize = {len(items)}\n'
            'item []:\n' + "".join(items))


SHORT_TG = textwrap.dedent('''\
    File type = "ooTextFile"
    Object class = "TextGrid"

    0
    1.0
    <exists>
    2
    "IntervalTier"
    "phones"
    0
    1.0
    3
    0
    0.5
    "HH"
    0.5
    0.8
    "say ""hi"""
    0.8
    1.0
    ""
    "TextTier"
    "events"
    0
    1.0
    2
    0.25
    "click"
    0.75
    "pop"
''')

ANNOTATED = [(0, 0.2, ""), (0.2, 0.3, "sp"), (0.3, 0.5, "HH1"),
             (0.5, 0.8, "AH0,AA2*,s"), (0.8, 0.9, "ER0"),
             (0.9, 0.95, "T,ERR,d"), (0.95, 1.0, "AX")]
CANONICAL = [(0, 0.2, ""), (0.2, 0.5, "HH1"), (0.5, 0.8, "AH0"),
             (0.8, 0.9, "ER0"), (0.9, 0.95, "T"), (0.95, 1.0, "")]


def _tiers(phones):
    return [("words", [(0, 1.0, "hello")]), ("phones", phones)]


def _write(path, text):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def make_l2_tree(root):
    """Utterances of a test, a dev and a train speaker, one of the two
    known-bad files, and an utterance without a transcript."""
    for spk, utts in (("NJS", ["arctic_a0001", "arctic_a0002"]),
                      ("ABA", ["arctic_b0100"]), ("MBMPS", ["arctic_a0001"]),
                      ("YDCK", ["arctic_a0209", "arctic_a0300"])):
        for n, utt in enumerate(utts):
            ann = ANNOTATED[: len(ANNOTATED) - n]
            _write(root / spk / "annotation" / f"{utt}.TextGrid",
                   textgrid_long(_tiers(ann)))
            _write(root / spk / "arpa_textgrid" / f"{utt}.TextGrid",
                   textgrid_long(_tiers(CANONICAL[: len(CANONICAL) - n])))
            if n == 0:
                _write(root / spk / "transcript" / f"{utt}.txt",
                       f"Hello {spk}\n")
            _write(root / spk / "wav" / f"{utt}.wav", "")


def make_timit_tree(root):
    """Two dialect regions in TRAIN, a lower-case test dir, SA sentences,
    the three wav spellings and an utterance without a .WRD file."""
    rows = "0 100 h#\n100 200 sh\n200 300 ix\n300 400 q\n400 450 axr\n" \
           "450 500 dx\n500 600 h#\n"
    for base, spk, stem, wav in (
            ("TRAIN/DR1", "FAKS0", "SI1234", ".WAV.wav"),
            ("TRAIN/DR1", "FAKS0", "SX100", ".WAV"),
            ("TRAIN/DR2", "MBMA0", "SI500", ".wav"),
            ("test/DR1", "mdab0", "SX20", ".WAV.wav")):
        d = root / base / spk
        _write(d / f"{stem}.PHN", rows)
        if stem != "SX100":
            _write(d / f"{stem}.WRD", "100 300 she\n300 600 had\n")
        _write(d / f"{stem}{wav}", "")
        _write(d / "SA1.PHN", "0 100 h#\n")
        _write(d / "SA1.WAV.wav", "")
    _write(root / "TRAIN/DR2/NOWAV0/SI1.PHN", "0 100 h#\n")


def assert_same_tree(ours, ref):
    names = sorted(p.name for p in ref.iterdir())
    assert sorted(p.name for p in ours.iterdir()) == names
    for name in names:
        assert (ours / name).read_bytes() == (ref / name).read_bytes(), name


def _intervals(tg):
    return [(t.name, [(iv.minTime, iv.maxTime, iv.mark) for iv in t])
            for t in tg]


@pytest.mark.parametrize("fmt", ["long", "short", "points"])
def test_textgrid_matches_jax(fmt, tmp_path):
    text = {"long": textgrid_long(_tiers(ANNOTATED)),
            "short": SHORT_TG,
            "points": textgrid_long(_tiers(CANONICAL),
                                    ("events", [(0.25, "a"), (0.5, "b")]))}[fmt]
    ours, ref = TextGrid.parse(text), JaxTextGrid.parse(text)
    assert _intervals(ours) == _intervals(ref)
    assert len(ours) == len(ref) >= 2
    path = tmp_path / "x.TextGrid"
    path.write_text(text)
    assert _intervals(TextGrid.fromFile(str(path))) == _intervals(ref)
    name = ref[1].name
    assert ours.get_tier_by_name(name).name == name
    with pytest.raises(KeyError):
        ours.get_tier_by_name("missing")


def test_textgrid_known_answers():
    """tests/test_prepare.py's checks, on the port's reader."""
    tg = TextGrid.parse(textgrid_long(_tiers(ANNOTATED)))
    assert [t.name for t in tg] == ["words", "phones"]
    assert tg[1][0].mark == "" and tg[1][3].mark == "AH0,AA2*,s"
    assert tg[1][3].minTime == pytest.approx(0.5)
    short = TextGrid.parse(SHORT_TG)
    assert [iv.mark for iv in short[0]] == ["HH", 'say "hi"', ""]
    assert [(iv.minTime, iv.mark) for iv in short[1]] == [(0.25, "click"),
                                                          (0.75, "pop")]


@pytest.mark.parametrize("split", ["train", "dev", "test"])
@pytest.mark.parametrize("keep_reduced", [True, False])
def test_prepare_l2arctic_matches_jax(split, keep_reduced, tmp_path):
    root = tmp_path / "l2"
    make_l2_tree(root)
    n = prepare.prepare_l2arctic(str(root), str(tmp_path / "ours"), split,
                                 keep_reduced=keep_reduced)
    n_ref = jax_prepare.prepare_l2arctic(str(root), str(tmp_path / "ref"),
                                         split, keep_reduced=keep_reduced)
    assert n == n_ref == {"train": 1, "dev": 2, "test": 2}[split]
    assert_same_tree(tmp_path / "ours", tmp_path / "ref")


def test_prepare_l2arctic_known_answer(tmp_path):
    root = tmp_path / "l2"
    make_l2_tree(root)
    prepare.prepare_l2arctic(str(root), str(tmp_path / "out"), "test")
    assert (tmp_path / "out" / "phn_text").read_text().splitlines()[0] == (
        "NJS_arctic_a0001 sil hh aa er0 err ah0")
    assert (tmp_path / "out" / "transcript_phn_text").read_text(
    ).splitlines()[0] == "NJS_arctic_a0001 sil hh ah0 er0 t sil"
    # the known-bad YDCK file is skipped, the other YDCK one is dev
    prepare.prepare_l2arctic(str(root), str(tmp_path / "dev"), "dev")
    assert "YDCK_arctic_a0300" in (tmp_path / "dev" / "wav.scp").read_text()
    assert "a0209" not in (tmp_path / "dev" / "wav.scp").read_text()


@pytest.mark.parametrize("scheme,speakers", [
    ("60-41", None), ("60-48", None), ("60-41", ["faks0", "MDAB0"]),
    ("60-48", ["OTHER"])])
def test_prepare_timit_matches_jax(scheme, speakers, tmp_path):
    root = tmp_path / "timit"
    make_timit_tree(root)
    n = prepare.prepare_timit(str(root), str(tmp_path / "ours"),
                              speakers=speakers, phoneme_map=scheme)
    n_ref = jax_prepare.prepare_timit(str(root), str(tmp_path / "ref"),
                                      speakers=speakers, phoneme_map=scheme)
    assert n == n_ref
    assert n == {None: 4, 2: 3, 1: 0}[speakers and len(speakers)]
    assert_same_tree(tmp_path / "ours", tmp_path / "ref")


def test_split_timit_speakers_matches_jax():
    spk = {"DR1": [f"S{i}" for i in range(10)],
           "DR2": [f"T{i}" for i in range(9)],
           "DR3": [f"U{i}" for i in range(3)]}
    for seed in range(5):
        for n_dev, n_test in ((4, 4), (1, 2)):
            assert (prepare.split_timit_speakers(spk, n_dev, n_test, seed)
                    == jax_prepare.split_timit_speakers(spk, n_dev, n_test,
                                                        seed))
    assert prepare.L2_SPLITS == jax_prepare.L2_SPLITS
    assert prepare.L2_LOAD_ERROR_FILES == jax_prepare.L2_LOAD_ERROR_FILES
    assert prepare.L2_MANDARIN_SPK == jax_prepare.L2_MANDARIN_SPK
    assert prepare.MERGE_FILES == jax_prepare.MERGE_FILES


def _data_dirs(tmp_path):
    dirs = []
    for k, (utt, phones) in enumerate((("u1", "sil aa bb"), ("u2", "bb cc"),
                                       ("u3", "dd sil aa"))):
        d = tmp_path / f"d{k}"
        d.mkdir()
        for name in prepare.MERGE_FILES:
            if not (k == 2 and name == "wrd_text"):   # one file missing
                (d / name).write_text(f"{utt} {phones}\n")
        dirs.append(str(d))
    return dirs


def test_merge_and_units_match_jax(tmp_path):
    dirs = _data_dirs(tmp_path)
    prepare.merge_data_dirs(dirs, str(tmp_path / "ours"))
    jax_prepare.merge_data_dirs(dirs, str(tmp_path / "ref"))
    assert_same_tree(tmp_path / "ours", tmp_path / "ref")
    phn = str(tmp_path / "ours" / "phn_text")
    units = prepare.build_units(phn, str(tmp_path / "units"))
    assert units == jax_prepare.build_units(phn, str(tmp_path / "units_ref"))
    assert units == ["sil", "aa", "bb", "cc", "dd"]
    assert filecmp.cmp(tmp_path / "units", tmp_path / "units_ref",
                       shallow=False)


def test_prep_subcommands_write_what_the_functions_write(tmp_path, capsys):
    l2, timit = tmp_path / "l2", tmp_path / "timit"
    make_l2_tree(l2)
    make_timit_tree(timit)
    spk_file = tmp_path / "speakers"
    spk_file.write_text("FAKS0\n\nMBMA0\n")
    assert cli.main(["prepare-timit", "--timit-dir", str(timit), "--out",
                     str(tmp_path / "timit_cli"), "--speakers-file",
                     str(spk_file), "--phoneme-map", "60-48"]) == 0
    jax_prepare.prepare_timit(str(timit), str(tmp_path / "timit_ref"),
                              speakers=["FAKS0", "MBMA0"],
                              phoneme_map="60-48")
    assert_same_tree(tmp_path / "timit_cli", tmp_path / "timit_ref")

    assert cli.main(["prepare-l2arctic", "--l2-dir", str(l2), "--out-root",
                     str(tmp_path / "l2_cli"), "--fold-reduced"]) == 0
    for split in ("train", "dev", "test"):
        jax_prepare.prepare_l2arctic(str(l2), str(tmp_path / "ref" / split),
                                     split, keep_reduced=False)
        assert_same_tree(tmp_path / "l2_cli" / f"l2_{split}",
                         tmp_path / "ref" / split)

    dirs = [str(tmp_path / "timit_cli"), str(tmp_path / "l2_cli" / "l2_test")]
    assert cli.main(["merge", "--dirs", *dirs, "--out",
                     str(tmp_path / "merged")]) == 0
    jax_prepare.merge_data_dirs(dirs, str(tmp_path / "merged_ref"))
    assert_same_tree(tmp_path / "merged", tmp_path / "merged_ref")

    assert cli.main(["units", "--phn-text",
                     str(tmp_path / "merged" / "phn_text"), "--out",
                     str(tmp_path / "units")]) == 0
    jax_prepare.build_units(str(tmp_path / "merged" / "phn_text"),
                            str(tmp_path / "units_ref"))
    assert filecmp.cmp(tmp_path / "units", tmp_path / "units_ref",
                       shallow=False)
    out = capsys.readouterr().out
    assert "prepared 3 TIMIT utterances" in out
    assert "prepared 2 L2-ARCTIC test utterances" in out
    assert "merged 2 dirs" in out and "units ->" in out
