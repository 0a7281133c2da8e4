"""Product inference: single-word pronunciation diagnosis (counterpart of
mdd_tpu/infer.py).

  resample -> fbank (device) + committed CMVN -> splice / skip / pad ->
  CTC-attention forward + greedy or beam decode (device) -> strip sil /
  drop err
  -> align decoded vs canonical -> per-phone fault lists -> 0-100 score.

The canonical phones come with each item: the lexicon (word -> phones,
IPA, translation, phonics) is not ported yet, so those display fields
are empty strings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mdd_tpu_torch.align.levenshtein import align
from mdd_tpu_torch.align.mdd import (
    align_canonical_decoded,
    fault_statistics,
    word_score,
)
from mdd_tpu_torch.data.dataset import Batch
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
from mdd_tpu_torch.models.ctc_model import ModelConfig


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
    phonics: str = ""


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
    # the reference's length gate: its silence.wav is 3 minutes long
    MAX_WAV_SECONDS = 180.0

    def __init__(
        self,
        model_cfg: ModelConfig,
        state_dict: Dict[str, torch.Tensor],
        vocab: Vocab,
        cmvn: CmvnStats,
        decode_type: str = "greedy",
        beam_width: int = 10,
        lm_path: Optional[str] = None,
        lm_alpha: float = 0.0,
        left_ctx: int = 0,
        right_ctx: int = 2,
        n_skip_frame: int = 2,
        n_downsample: int = 2,
        device: str | torch.device = "cuda",
    ):
        self.session = EvalSession(model_cfg, state_dict, vocab,
                                   decode_type=decode_type,
                                   beam_width=beam_width, lm_path=lm_path,
                                   lm_alpha=lm_alpha, device=device)
        self.vocab = vocab
        self.cmvn = cmvn
        self.fbank = BatchedFbank(FbankConfig(), device)
        self.left_ctx, self.right_ctx = left_ctx, right_ctx
        self.n_skip_frame, self.n_downsample = n_skip_frame, n_downsample

    # ------------------------------------------------------------------
    def _prepare_audio(self, wav_path: str) -> Optional[np.ndarray]:
        data, sr = read_audio(wav_path)
        if data.ndim > 1:
            data = data[:, 0]
        if sr != 16000:
            data = resample(data, sr, 16000)
        if len(data) / 16000.0 > self.MAX_WAV_SECONDS:
            return None   # infer.py:509-511
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

    @staticmethod
    def _word_meta(word: str, canonical_units: Optional[List[str]]):
        """(canonical, ipa, translation, phonics) for one word."""
        if canonical_units is None:
            raise ValueError(
                f"no canonical phones for {word!r}: the lexicon (word -> "
                "phones) is not ported yet, so each item must carry them")
        return list(canonical_units), "", "", ""

    def diagnose_words(
        self,
        items: List[Tuple[str, np.ndarray, str, Optional[List[str]]]],
        time_quantum: int = 32,
    ) -> List[WordDiagnosis]:
        """Diagnose several recorded words in batched forwards.

        items: (utt_id, wav, word, canonical_units) tuples.  Items are
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
               batch_sizes: Optional[Sequence[int]] = None) -> int:
        """Run every (BATCH_SIZES rung, length bucket up to `max_seconds`)
        shape once before serving, so allocator growth and cuDNN algorithm
        selection happen before the first client request.  Returns the
        number of shapes run."""
        unit = self.vocab.index2word[2]  # any real unit
        n = 0
        for b in batch_sizes or self.BATCH_SIZES:
            secs = 0.64   # one wav length per 32-model-frame bucket
            while secs <= max_seconds + 1e-9:
                wav = np.zeros(int(secs * 16000), np.float32)
                self.diagnose_words([(f"_warm{i}", wav, "a", [unit])
                                     for i in range(b)])
                n += 1
                secs += 0.64
        return n

    def diagnose_word(self, utt_id: str, wav: np.ndarray, word: str,
                      canonical_units: Optional[List[str]] = None
                      ) -> WordDiagnosis:
        """Diagnose one recorded word against its canonical phones."""
        meta = (utt_id, word) + self._word_meta(word, canonical_units)
        feats = self._featurize({utt_id: wav})[utt_id]
        decoded_lists, _ = self.session.decode_batch(
            self._model_batch(utt_id, feats, meta[2]))
        return self._diagnose_decoded(meta, decoded_lists[0])

    def _diagnose_decoded(self, meta, decoded_raw) -> WordDiagnosis:
        """Alignment + faults + score for one decoded word."""
        utt_id, word, canonical_units, ipa_display, translation, phonics = meta
        decoded = [p for p in decoded_raw if p not in ("sil", "err")]
        canonical = [p for p in canonical_units if p != "sil"]
        _, dc_path = align(decoded, canonical)
        dec, can, ops = align_canonical_decoded(decoded, canonical, dc_path)
        ins_f, sub_f, del_f = fault_statistics(ops, can, dec)
        score, correct, total = word_score(ops, len(ins_f))
        can_row, ops_row, dec_row = _aligned_rows(dec, can, ops)
        return WordDiagnosis(
            utt_id=utt_id, word=word, ipa_display=ipa_display,
            translation=translation, canonical_row=can_row, ops_row=ops_row,
            decoded_row=dec_row, insertion_faults=ins_f,
            substitution_faults=sub_f, deletion_faults=del_f,
            correct=correct, total=total, score=score, phonics=phonics)
