"""Product inference: single-word pronunciation diagnosis (counterpart of
mdd_tpu/infer.py).  For each recorded word (one `N.wav` + `N.txt` prompt
pair of a directory in `diagnose_dir`, or one serving request):

  resample -> denoise (host, optional) -> fbank (device) + committed
  CMVN -> splice / skip / pad ->
  CTC-attention forward + greedy or beam decode (device) -> strip sil /
  drop err -> align decoded vs canonical -> optional forgiveness of
  confusable phones -> per-phone fault lists -> 0-100 score ->
  printable report (+ the RTF breakdown in diagnose_dir).

The canonical phones, the IPA display, the translation and the phonics
come from the word through the lexicon (lexicon/dictionary.Phonetic),
unless an item carries its own canonical phones (a TextGrid prompt, or a
request's "canonical").  The denoise stage is the engine's `denoiser`
hook ((waveform, sample rate) -> waveform), applied after resampling and
before the length gate, as in mdd_tpu; the `infer` and `serve` commands
pass the native spectral denoiser (native.spectral_denoise) unless given
`--no-denoise`.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mdd_tpu_torch.align.levenshtein import align
from mdd_tpu_torch.align.mdd import (
    align_canonical_decoded,
    apply_forgiveness,
    fault_statistics,
    word_score,
)
from mdd_tpu_torch.data.dataset import Batch
from mdd_tpu_torch.data.textgrid import TextGrid
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.evals.evaluate import EvalSession
from mdd_tpu_torch.frontend.cmvn import CmvnStats, apply_cmvn
from mdd_tpu_torch.frontend.fbank import FbankConfig
from mdd_tpu_torch.frontend.pipeline import BatchedFbank
from mdd_tpu_torch.frontend.splice import (
    make_context,
    pad_to_multiple,
    skip_frames,
)
from mdd_tpu_torch.frontend.wav import read_audio, resample
from mdd_tpu_torch.lexicon.dictionary import CMU_TO_IPA_WIKI, Phonetic
from mdd_tpu_torch.lexicon.phones import normalize_canonical_phone
from mdd_tpu_torch.models.ctc_model import ModelConfig


def read_phonemes_from_textgrid(path: str) -> List[str]:
    """Canonical phones from a TextGrid's second tier (the reference's
    `--phonetic transcript` mode, infer.py:374-403).

    The reference function drops every non-empty mark (an indentation
    slip); as mdd_tpu does, this implements its evident intent: strip
    stress digits, fold the reduced vowels (AX/AH0 -> ah, ER0 -> er: this
    path uses the 39-phone set), map silence and error tokens, lowercase.
    """
    return [normalize_canonical_phone(iv.mark or "", keep_reduced=False)
            for iv in TextGrid.fromFile(path)[1]]


@dataclasses.dataclass
class WordDiagnosis:
    utt_id: str
    word: str
    ipa_display: str
    translation: str
    canonical_row: str
    ops_row: str
    decoded_row: str
    insertion_faults: List[str]
    substitution_faults: List[str]
    deletion_faults: List[str]
    correct: int
    total: int
    score: int
    phonics: str = ""   # letter -> IPA breakdown (phonics_engine.csv)

    def render(self) -> str:
        lines = [
            "id     : " + self.utt_id,
            f"{self.utt_id}: {self.word}",
            self.ipa_display,
        ]
        if self.phonics:
            lines.append("phonics: " + self.phonics)
        if self.translation:
            lines.append(self.translation)
        lines += [
            self.canonical_row,
            self.ops_row,
            self.decoded_row,
            "ins err: " + " ".join(self.insertion_faults),
            "sub err: " + " ".join(self.substitution_faults),
            "del err: " + " ".join(self.deletion_faults),
            f"Comp.  : {self.correct}/{self.total}",
            f"score  : {self.score}",
            "",
        ]
        return "\n".join(lines)


def _aligned_rows(decoded: Sequence[str], canonical: Sequence[str],
                  ops: Sequence[str]) -> Tuple[str, str, str]:
    """Column-aligned canonical / op / decoded display rows."""
    widths = [max(len(str(canonical[i])), len(str(decoded[i])), 1)
              for i in range(len(ops))]
    can = " ".join(str(canonical[i]).ljust(widths[i]) for i in range(len(ops)))
    op = " ".join(str(ops[i]).ljust(widths[i]) for i in range(len(ops)))
    dec = " ".join(str(decoded[i]).ljust(widths[i]) for i in range(len(ops)))
    return ("canonical : " + can, "            " + op, "decode    : " + dec)


class InferenceEngine:
    """End-to-end single-word diagnosis on one device."""

    # label axis padded to a multiple of this (as in mdd_tpu, so a batch
    # and a single-word call see the same shapes)
    LABEL_QUANTUM = 8
    # serving batch-size ladder: diagnose_words pads each length-bucket
    # group up to the next size here (beyond the last, next pow2)
    BATCH_SIZES = (1, 4, 16)

    def __init__(
        self,
        model_cfg: ModelConfig,
        state_dict: Dict[str, torch.Tensor],
        vocab: Vocab,
        cmvn: CmvnStats,
        phonetic: Optional[Phonetic] = None,
        decode_type: str = "greedy",
        beam_width: int = 10,
        lm_path: Optional[str] = None,
        lm_alpha: float = 0.0,
        left_ctx: int = 0,
        right_ctx: int = 2,
        n_skip_frame: int = 2,
        n_downsample: int = 2,
        max_wav_seconds: float = 180.0,   # the reference's length gate:
        # its silence.wav is 3 minutes long (infer.py:509-511)
        use_ipa: bool = False,
        forgiving: Optional[int] = None,   # g_pairs level; None is the
        # reference's strict criterion (infer.py:69-153)
        device: str | torch.device = "cuda",
        denoiser: Optional[Callable[[np.ndarray, int], np.ndarray]] = None,
    ):
        t0 = time.time()
        self.session = EvalSession(model_cfg, state_dict, vocab,
                                   decode_type=decode_type,
                                   beam_width=beam_width, lm_path=lm_path,
                                   lm_alpha=lm_alpha, device=device)
        self.fbank = BatchedFbank(FbankConfig(), device)
        t1 = time.time()
        self.vocab = vocab
        self.cmvn = cmvn
        self.phonetic = phonetic or Phonetic()
        # fail here, not at the first word, when the CMUdict files are
        # missing: a server would otherwise come up and fail every request
        self.phonetic.validate_assets()
        # init-stage wall clock for the RTF report of diagnose_dir
        self._model_init_s = t1 - t0
        self._phone_init_s = time.time() - t1
        self.left_ctx, self.right_ctx = left_ctx, right_ctx
        self.n_skip_frame, self.n_downsample = n_skip_frame, n_downsample
        self.max_wav_seconds = max_wav_seconds
        self.denoiser = denoiser
        self.use_ipa = use_ipa
        self.forgiving = forgiving

    # ------------------------------------------------------------------
    def _prepare_audio(self, wav_path: str) -> Optional[np.ndarray]:
        data, sr = read_audio(wav_path)
        if data.ndim > 1:
            data = data[:, 0]
        if sr != 16000:
            data = resample(data, sr, 16000)
        if self.denoiser is not None:
            data = self.denoiser(data, 16000)
        if len(data) / 16000.0 > self.max_wav_seconds:
            return None
        return data.astype(np.float32)

    def _featurize(self, wavs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {}
        utts = sorted(wavs)
        for s in range(0, len(utts), 16):
            chunk = utts[s:s + 16]
            for u, f in zip(chunk, self.fbank([wavs[u] for u in chunk])):
                out[u] = apply_cmvn(f, self.cmvn)
        return out

    def _model_input(self, feats: np.ndarray) -> np.ndarray:
        return np.asarray(pad_to_multiple(
            skip_frames(make_context(feats, self.left_ctx, self.right_ctx),
                        self.n_skip_frame), self.n_downsample), np.float32)

    def _model_batch(self, utt: str, feats: np.ndarray,
                     canonical_units: List[str]) -> Batch:
        ids = self.vocab.encode(canonical_units)
        l_pad = -(-len(ids) // self.LABEL_QUANTUM) * self.LABEL_QUANTUM
        trans = np.zeros((1, l_pad), np.int32)
        trans[0, : len(ids)] = ids
        sizes = np.asarray([len(ids)], np.int32)
        return Batch(inputs=self._model_input(feats)[None],
                     input_fracs=np.ones(1, np.float32),
                     targets=trans.copy(), target_sizes=sizes.copy(),
                     trans=trans, trans_sizes=sizes, utt_ids=[utt])

    def _word_meta(self, word: str, canonical_units: Optional[List[str]]):
        """(canonical, ipa, translation, phonics) for one word, from the
        lexicon (host side); `canonical_units` overrides its phones."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if canonical_units is None:
                canonical_units = self.phonetic.canonical_model_phones(word)
            ipa_display = self.phonetic.api_word_phonetic(word)
            translation = self.phonetic.api_word_translation(word)
            phonics_entry = self.phonetic.api_word_phonics(word)
        phonics = ("" if phonics_entry is None else " ".join(
            "-".join(m) for m in phonics_entry["mapping"]))
        return list(canonical_units), ipa_display, translation, phonics

    def diagnose_words(
        self,
        items: List[Tuple[str, np.ndarray, str, Optional[List[str]]]],
        time_quantum: int = 32,
    ) -> List[WordDiagnosis]:
        """Diagnose several recorded words in batched forwards.

        items: (utt_id, wav, word, canonical_units-or-None) tuples.  Items are
        bucketed by padded model-frame length (a multiple of
        `time_quantum`), one forward per bucket, so a wav's diagnosis never
        depends on what it was batched with (the unpacked backward LSTM
        direction would otherwise see a co-batch's extra padding)."""
        if not items:
            return []
        ids = [utt for utt, *_ in items]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate utt_ids in diagnose_words: {ids}")
        metas = [(utt, word) + self._word_meta(word, canonical)
                 for utt, _, word, canonical in items]
        feats = self._featurize({utt: wav for utt, wav, *_ in items})
        xs = [self._model_input(feats[m[0]]) for m in metas]
        trans_ids = [self.vocab.encode(m[2]) for m in metas]
        buckets: Dict[int, List[int]] = {}
        for i, x in enumerate(xs):
            t_pad = -(-x.shape[0] // time_quantum) * time_quantum
            buckets.setdefault(t_pad, []).append(i)
        out: List[Optional[WordDiagnosis]] = [None] * len(items)
        for t_max in sorted(buckets):
            group = buckets[t_max]
            # pad the group up the BATCH_SIZES ladder by repeating its last
            # item (extra rows' outputs are dropped): the shape set stays
            # the small one warmup() covers
            n_real = len(group)
            b = next((s for s in self.BATCH_SIZES if s >= n_real),
                     1 << (n_real - 1).bit_length())
            group = group + [group[-1]] * (b - n_real)
            l_max = (-(-max(len(trans_ids[i]) for i in group)
                       // self.LABEL_QUANTUM) * self.LABEL_QUANTUM)
            inputs = np.zeros((b, t_max, xs[0].shape[1]), np.float32)
            fracs = np.zeros(b, np.float32)
            trans = np.zeros((b, l_max), np.int32)
            trsizes = np.zeros(b, np.int32)
            out_max = self.session.cfg.output_frames(t_max)
            for k, i in enumerate(group):
                x, t = xs[i], trans_ids[i]
                inputs[k, : x.shape[0]] = x
                # frac chosen so floor(frac * out_len) lands exactly on the
                # item's own model frame count (the single-word path uses
                # frac = 1.0; the batch must match it)
                n_i = self.session.cfg.output_frames(x.shape[0])
                fracs[k] = min(1.0, (n_i + 0.5) / out_max)
                trans[k, : len(t)] = t
                trsizes[k] = len(t)
            batch = Batch(inputs=inputs, input_fracs=fracs,
                          targets=trans.copy(), target_sizes=trsizes.copy(),
                          trans=trans, trans_sizes=trsizes,
                          utt_ids=[metas[i][0] for i in group])
            decoded_lists, _ = self.session.decode_batch(batch)
            for i, decoded in zip(group[:n_real], decoded_lists):
                out[i] = self._diagnose_decoded(metas[i], decoded)
        return out  # type: ignore[return-value]

    def warmup(self, max_seconds: float = 3.2,
               batch_sizes: Optional[Sequence[int]] = None,
               max_canonical_phones: int = 16) -> int:
        """Run every (BATCH_SIZES rung, LABEL_QUANTUM width up to
        `max_canonical_phones`, length bucket up to `max_seconds`) shape
        once before serving, so allocator growth and cuDNN algorithm
        selection happen before the first client request; with the
        lexicon, label widths vary from word to word.  The items carry
        canonical phones, so no dictionary lookup decides a shape.
        Returns the number of shapes run."""
        unit = self.vocab.index2word[2]  # any real unit
        n = 0
        for b in batch_sizes or self.BATCH_SIZES:
            for llen in range(1, max_canonical_phones + 1,
                              self.LABEL_QUANTUM):
                secs = 0.64   # one wav length per 32-model-frame bucket
                while secs <= max_seconds + 1e-9:
                    wav = np.zeros(int(secs * 16000), np.float32)
                    self.diagnose_words([(f"_warm{i}", wav, "a",
                                          [unit] * llen) for i in range(b)])
                    n += 1
                    secs += 0.64
        return n

    def diagnose_word(self, utt_id: str, wav: np.ndarray, word: str,
                      canonical_units: Optional[List[str]] = None
                      ) -> WordDiagnosis:
        """Diagnose one recorded word against its prompt."""
        meta = (utt_id, word) + self._word_meta(word, canonical_units)
        feats = self._featurize({utt_id: wav})[utt_id]
        decoded_lists, _ = self.session.decode_batch(
            self._model_batch(utt_id, feats, meta[2]))
        return self._diagnose_decoded(meta, decoded_lists[0])

    def _diagnose_decoded(self, meta, decoded_raw) -> WordDiagnosis:
        """Alignment + forgiveness + faults + score for one decoded word."""
        utt_id, word, canonical_units, ipa_display, translation, phonics = meta
        decoded = [p for p in decoded_raw if p not in ("sil", "err")]
        canonical = [p for p in canonical_units if p != "sil"]
        _, dc_path = align(decoded, canonical)
        dec, can, ops = align_canonical_decoded(decoded, canonical, dc_path)
        if self.forgiving is not None:
            dec, can, ops = apply_forgiveness(dec, can, ops, self.forgiving)
        if self.use_ipa:
            # display symbols after alignment and forgiveness, whose pair
            # tables are keyed by model units; 'D' / 'I' pass unchanged
            dec = [CMU_TO_IPA_WIKI.get(p.upper(), p) for p in dec]
            can = [CMU_TO_IPA_WIKI.get(p.upper(), p) for p in can]
        ins_f, sub_f, del_f = fault_statistics(ops, can, dec)
        score, correct, total = word_score(ops, len(ins_f))
        can_row, ops_row, dec_row = _aligned_rows(dec, can, ops)
        return WordDiagnosis(
            utt_id=utt_id, word=word, ipa_display=ipa_display,
            translation=translation, canonical_row=can_row, ops_row=ops_row,
            decoded_row=dec_row, insertion_faults=ins_f,
            substitution_faults=sub_f, deletion_faults=del_f,
            correct=correct, total=total, score=score, phonics=phonics)

    def diagnose_dir(self, wav_dir: str, log=print,
                     textgrid_dir: Optional[str] = None,
                     decode_dump: Optional[str] = None
                     ) -> List[WordDiagnosis]:
        """The demo flow over a directory of N.wav + N.txt pairs
        (reference infer.py:486-597): one report per pair, in name order,
        then the RTF breakdown.

        With `textgrid_dir`, the canonical phones come from its
        N.TextGrid files instead of the lexicon (a pair without one is
        skipped); `decode_dump` writes one "N phones..." line per pair
        (the reference's decode_seq.txt)."""
        t0 = time.time()
        items: List[Tuple[str, np.ndarray, str, Optional[List[str]]]] = []
        total_audio = 0.0
        for p in sorted(Path(wav_dir).iterdir(), key=lambda q: q.name):
            if p.suffix != ".wav":
                continue
            canonical = None
            if textgrid_dir is not None:
                tg = Path(textgrid_dir) / (p.stem + ".TextGrid")
                if not tg.exists():
                    continue
                canonical = read_phonemes_from_textgrid(str(tg))
            txt = p.with_suffix(".txt")
            if not txt.exists():
                continue
            wav = self._prepare_audio(str(p))
            if wav is None:
                log(f"{p} skipped, wav length over "
                    f"{self.max_wav_seconds:.0f}s limit")
                continue
            total_audio += len(wav) / 16000.0
            items.append((p.stem, wav, txt.read_text().strip(), canonical))
        t1 = time.time()

        results = []
        dump = open(decode_dump, "w") if decode_dump else None
        try:
            for utt, wav, word, canonical in items:
                diag = self.diagnose_word(utt, wav, word, canonical)
                log(diag.render())
                results.append(diag)
                if dump is not None:
                    decoded = diag.decoded_row.split(":", 1)[1].split()
                    dump.write(f"{utt} {' '.join(decoded)}\n")
        finally:
            if dump is not None:
                dump.close()
        t2 = time.time()

        if total_audio > 0:
            # the reference's 4-way breakdown (infer.py:588-597): model
            # init / phone init / audio load and denoise / diagnosis, each
            # over the audio's length
            load_s, mdd_s = t1 - t0, t2 - t1
            time_used = (self._model_init_s + self._phone_init_s
                         + load_s + mdd_s)
            log("RTF: %.4f, time used for decode %d sentences: %.4f "
                "seconds, total wav length: %.4f seconds"
                % (time_used / total_audio, len(items), time_used,
                   total_audio))
            log("init model time: %.4f, init phone time: %.4f, "
                "denoise time: %.4f, mdd infer time: %.4f"
                % (self._model_init_s / total_audio,
                   self._phone_init_s / total_audio,
                   load_s / total_audio, mdd_s / total_audio))
            log("process time: %.4f" % ((load_s + mdd_s) / total_audio))
        return results
