"""Benchmark of the port (counterpart of the repo-root bench.py, which
`mdd_tpu benchmark` runs): training and decode throughput of the flagship
model, the feature front end, evaluation and whole epochs, on every card
of the host as bench.py runs on its local mesh.

    python -m mdd_tpu_torch benchmark [--device cuda|cpu]

Primary metric: audio-seconds of speech processed per second by the full
training step (forward + CTC loss + backward + Adam update) at batch 512
x 160 model-input frames in bfloat16.  The pipeline is 16 kHz -> 100 fps
fbank -> frame-skip 2, so one model-input frame is 0.02 s of audio and
160 frames a ~3.2 s utterance (the TIMIT / L2-ARCTIC average).

Baseline: the reference (one GPU, torch) trains an epoch of 5,496 + 897
utterances (~21,700 audio-seconds) in ~68.5 s (result/train.log:280), ~317
audio-s/s; vs_baseline = ours / 317.  It decodes the 900-utterance test
set in 3.25 min (result/train.log:3703-3705).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
`extra` holds every key mdd_tpu's bench.py writes, and `card` (the
nvidia-smi name and power limit), `peak_flops` (what `mfu` divides by:
the card's dense peak for the compute dtype, null for a card not in
PEAK_FLOPS), `decode_lm` / `eval_lm` (the ARPA file used, or null),
`eval_n_utts` (the utterances every evaluation pass scored) and
`epoch_corpus_s` (the host's time to write the epoch corpus, in no rate).

Where it differs from mdd_tpu's bench.py, on purpose:
  * units: the reference recipe's `units` where its data directory is
    given (MDD_REFERENCE_DATA, see `reference_data`), else
    lexicon.phones.CANONICAL_UNITS_41 (that file's units in its order),
    so the head always has the flagship's 43 classes; mdd_tpu falls back
    to a 23-phone synthetic set (a 25-class head);
  * evaluation weights: both take the committed trained model
    `checkpoints/syn_full/best` where it is present and its head fits the
    units (`eval_checkpoint: "syn_full/best"`), else seeded random ones
    (`"random_init"`); the port reads the orbax files itself and raises
    on a read error, where bench.py falls back to random weights in a
    bare `except`;
  * a rank a card: `benchmark` starts a rank on every visible card
    (parallel/launch.py) where bench.py spreads one process over its
    mesh, and rank 0 prints the line, with `n_cards`.  The train, eval
    and epoch sections spread over the cards as bench.py's do (each
    global batch shared by the ranks); train and epoch rates are divided
    by the card count and `mfu` by the count times a card's peak, where
    bench.py divides by its chip count; decode and the front end run on
    rank 0's card alone, as bench.py's run on one device.  A run under
    torchrun with WORLD_SIZE > 1 raises SystemExit.
The LM is read only from the reference recipe's data directory, as
mdd_tpu reads it only from its mount.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from mdd_tpu_torch.parallel import mesh

BASELINE_AUDIO_SEC_PER_S = 317.0
SECONDS_PER_INPUT_FRAME = 0.02  # 10 ms hop x frame-skip 2

BATCH = 512    # bench.py's: throughput flat beyond ~512 on its chip
FRAMES = 160   # ~3.2 s per utterance
LABEL_LEN = 48
WARMUP_STEPS = 5
BENCH_STEPS = 30

DECODE_BATCH = 512
DECODE_FRAMES = 80   # model output frames for a 3.2 s utterance
DECODE_ROUNDS = 6    # timed rounds; mean reported with min/max dispersion
BEAM_WIDTH = 10
REFERENCE_DECODE_MIN_900 = 3.25   # result/train.log:3703-3705

FRONTEND_BATCH = 128
FRONTEND_SECONDS = 3.0
FRONTEND_ROUNDS = 20
FEAT_UTTS = 900       # the reference's test-set scale
EVAL_UTTS = 900       # result/train.log:55
EVAL_PASSES = 3
# the trained model bench.py evaluates, in the repo beside the package
EVAL_CHECKPOINT_DIR = str(Path(__file__).resolve().parents[1]
                          / "checkpoints" / "syn_full")
EPOCH_UTTS = 5496     # the reference's training-set scale, train.log:54
EPOCHS = 3
LOADER_WORKERS = 8

# Dense peak FLOP/s of a card by torch.cuda.get_device_name and compute
# dtype: NVIDIA's H100 SXM data sheet at its 700 W limit (bf16 on the
# tensor cores; float32 outside them).  A card not listed has no MFU.
H100_SXM = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = {
    H100_SXM: {"bfloat16": 989e12, "float32": 67e12},
}

# The reference recipe's data directory (egs/attention_aug/data, with its
# `units` and `lm_phone_bg.arpa`), where it is mounted
REFERENCE_DATA_ENV = "MDD_REFERENCE_DATA"


def train_step_flops(cfg, batch: int, frames: int, label_len: int) -> float:
    """Analytic FLOP count of one training step (fwd + bwd ~= 3x fwd).

    Counts the matrix work (convs, LSTM gate matmuls, projections,
    attention, head); elementwise / BN / CTC work is bandwidth-bound and
    excluded, so the MFU reported from it is a slight underestimate.
    The same count as mdd_tpu's bench.py."""
    t, f = frames, cfg.input_dim
    flops = 0.0
    cin = 1
    for (kt, kf), (st, sf), (pt, pf), ch in zip(
            cfg.conv_kernels, cfg.conv_strides, cfg.conv_padding,
            cfg.conv_channels):
        t = (t + 2 * pt - kt) // st + 1
        f = (f + 2 * pf - kf) // sf + 1
        flops += 2.0 * t * f * ch * kt * kf * cin
        cin = ch
    t_out = t
    h = cfg.rnn_hidden_size
    d_in = f * cin
    for layer in range(cfg.rnn_layers):
        d = d_in if layer == 0 else 2 * h
        flops += 2.0 * t_out * 2 * (d * 4 * h + h * 4 * h)   # both directions
    if cfg.use_text_attention:
        le = label_len
        e = cfg.text_embed_size
        flops += 2.0 * le * 2 * (e * 4 * h + h * 4 * h)      # text BiLSTM
        flops += 2.0 * le * (2 * h) * (2 * h)                # key projection
        flops += 2.0 * t_out * le * (2 * h) * 2              # scores + context
        head_in = 4 * h
    else:
        head_in = 2 * h
    flops += 2.0 * t_out * head_in * cfg.num_class
    return 3.0 * batch * flops       # fwd + bwd


def peak_flops(card_name: str, compute_dtype: str) -> Optional[float]:
    """The card's dense peak for the dtype, None for a card not listed."""
    return PEAK_FLOPS.get(card_name, {}).get(compute_dtype)


def model_flops_utilization(flops: float, step_seconds: float,
                            peak: Optional[float]) -> Optional[float]:
    """The whole step's share of the card's peak: flops / s / peak."""
    if peak is None:
        return None
    return flops / step_seconds / peak


def card_name(device: str) -> str:
    """torch's name of the card `device` is on, or "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev)


def card_line(device: str) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the card `device` is
    on (its name and power limit), or "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return f"{card_name(device)}, power limit not read"
    index = dev.index or 0
    return lines[index] if index < len(lines) else lines[0]


def reference_data() -> Optional[Path]:
    """The reference recipe's data directory named by MDD_REFERENCE_DATA,
    or None when it is unset or not a directory."""
    path = os.environ.get(REFERENCE_DATA_ENV)
    if path and Path(path).is_dir():
        return Path(path)
    return None


def flagship_phones() -> List[str]:
    """The reference's committed units (`units` of the reference data
    directory, when it holds `sil`), else CANONICAL_UNITS_41, which is
    that file in its order: the flagship's 41 units, a 43-class head."""
    from mdd_tpu_torch.lexicon.phones import CANONICAL_UNITS_41
    from mdd_tpu_torch.tools.synthetic_corpus import read_units

    data = reference_data()
    if data is not None and (data / "units").exists():
        phones = read_units(str(data / "units"))
        if "sil" in phones:
            return phones
    return list(CANONICAL_UNITS_41)


def reference_lm() -> Optional[str]:
    """The reference recipe's bigram LM (`lm_phone_bg.arpa`), or None."""
    data = reference_data()
    if data is not None and (data / "lm_phone_bg.arpa").exists():
        return str(data / "lm_phone_bg.arpa")
    return None


def flagship_config(device: str):
    """The flagship model in bfloat16, its head sized to flagship_phones,
    the acoustic recurrence on the hand-written kernels on a card."""
    from mdd_tpu_torch.models.ctc_model import ModelConfig

    return ModelConfig(num_class=len(flagship_phones()) + 2,
                       compute_dtype="bfloat16",
                       use_pallas_lstm=torch.device(device).type == "cuda")


def n_cards() -> int:
    """The cards a section spreads over: the ranks of the local mesh
    (parallel/launch.py), else this process's one."""
    return mesh.process_count() if mesh.local_mesh() else 1


def rank_rows(batch):
    """-> (this rank's rows of `batch` on the local mesh, their valid
    mask): ceil(B / N) rows a rank, the slots past the batch repeating
    its last row, masked; the batch itself in one process."""
    from mdd_tpu_torch.data.dataset import Batch

    share = -(-batch.size // n_cards())
    slots = np.arange(share) + mesh.process_index() * share
    idx = np.minimum(slots, batch.size - 1)
    return Batch(batch.inputs[idx], batch.input_fracs[idx],
                 batch.targets[idx], batch.target_sizes[idx],
                 batch.trans[idx], batch.trans_sizes[idx],
                 [batch.utt_ids[i] for i in idx]), slots < batch.size


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train_batch(cfg, batch: int, frames: int, label_len: int):
    """bench.py's seeded batch: (batch, frames, input_dim) normal inputs
    at full length, random label and transcript ids of label_len."""
    from mdd_tpu_torch.data.dataset import Batch

    rng = np.random.default_rng(0)
    return Batch(
        inputs=rng.standard_normal(
            (batch, frames, cfg.input_dim)).astype(np.float32),
        input_fracs=np.full((batch,), 1.0, np.float32),
        targets=rng.integers(2, cfg.num_class,
                             (batch, label_len)).astype(np.int32),
        target_sizes=np.full((batch,), label_len, np.int32),
        trans=rng.integers(2, cfg.num_class,
                           (batch, label_len)).astype(np.int32),
        trans_sizes=np.full((batch,), label_len, np.int32),
        utt_ids=[f"utt{i}" for i in range(batch)])


def bench_train(cfg, extra: dict, device: str, batch: int = BATCH,
                frames: int = FRAMES, label_len: int = LABEL_LEN,
                warmup: int = WARMUP_STEPS, steps: int = BENCH_STEPS) -> float:
    """Trainer steps on one seeded batch (`train_batch`), shared by the
    cards: `warmup` steps, a synchronize, then `steps` timed up to a
    synchronize after the last; -> audio-seconds per second and card.
    Writes ms_per_step, tflop_per_step, peak_flops, mfu (over the cards'
    peak) and train_batch."""
    from mdd_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, device=device, device_frontend=False)
    arrays = trainer.batch_arrays(*rank_rows(
        train_batch(cfg, batch, frames, label_len)))
    acc = torch.zeros(4, dtype=torch.float32, device=trainer.device)
    for _ in range(warmup):
        acc = trainer.train_step(arrays, acc)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        acc = trainer.train_step(arrays, acc)
    _sync(device)
    elapsed = time.perf_counter() - t0
    # the ranks' shares of the loss (a share of padding adds 0)
    loss_sum = float(mesh.all_reduce_metrics(np.asarray([float(acc[0])]))[0])
    if not loss_sum > 0.0:
        raise RuntimeError(f"train steps summed a loss of {loss_sum}")

    flops = train_step_flops(cfg, batch, frames, label_len)
    peak = peak_flops(card_name(device), cfg.compute_dtype)
    cards = n_cards()
    mfu = model_flops_utilization(flops, elapsed / steps,
                                  None if peak is None else peak * cards)
    extra["ms_per_step"] = round(elapsed / steps * 1e3, 2)
    extra["tflop_per_step"] = round(flops / 1e12, 3)
    extra["peak_flops"] = peak
    extra["mfu"] = None if mfu is None else round(mfu, 4)
    extra["train_batch"] = batch
    return (steps * batch * frames * SECONDS_PER_INPUT_FRAME / elapsed
            / cards)


def bench_decode(extra: dict, device: str, batch: int = DECODE_BATCH,
                 frames: int = DECODE_FRAMES, rounds: int = DECODE_ROUNDS,
                 beam_width: int = BEAM_WIDTH) -> List[List[int]]:
    """The batched device beam (K=beam_width, the reference LM where
    there is one) through `decode_log` on log-probs already on the device,
    as EvalSession feeds it: one warm round, then `rounds` timed, each to
    its host sequences; -> the last round's sequences."""
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.decode.beam_jit import BatchedBeamDecoder

    vocab = Vocab(flagship_phones())
    lm_path = reference_lm()
    lm = None
    if lm_path is not None:
        from mdd_tpu_torch.decode.arpa import ArpaBigramLM
        lm = ArpaBigramLM(lm_path)
    dec = BatchedBeamDecoder(vocab.index2word, beam_width=beam_width, lm=lm,
                             lm_alpha=0.5, device=device)
    rng = np.random.default_rng(0)
    logits = rng.standard_normal(
        (batch, frames, vocab.n_words)).astype(np.float32)
    logits[:, :, 0] += 2.0    # blank-dominated posteriors
    logits = torch.from_numpy(logits).to(device)
    log_probs = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    lengths = [frames] * batch

    dec.decode_log(log_probs, lengths)          # warm
    rates = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        out = dec.decode_log(log_probs, lengths)
        rates.append(batch / (time.perf_counter() - t0))
    if len(out) != batch:
        raise RuntimeError(f"{len(out)} sequences for {batch} rows")
    utts_per_s = float(np.mean(rates))
    extra["decode_utts_per_s"] = round(utts_per_s, 1)
    extra["decode_utts_per_s_min"] = round(float(np.min(rates)), 1)
    extra["decode_utts_per_s_max"] = round(float(np.max(rates)), 1)
    extra["decode_beam_width"] = beam_width
    extra["decode_min_per_900_utts"] = round(900 / utts_per_s / 60, 4)
    extra["decode_vs_reference"] = round(
        REFERENCE_DECODE_MIN_900 / (900 / utts_per_s / 60), 1)
    extra["decode_lm"] = lm_path
    return out


def write_wavs(out: Path, n: int, seconds: float,
               rng: np.random.Generator) -> str:
    """`n` seeded 16 kHz PCM16 wavs of `seconds` under out/wav; -> the
    wav.scp path."""
    (out / "wav").mkdir(parents=True)
    pcm_t = int(16000 * seconds)
    lines = []
    for i in range(n):
        path = out / "wav" / f"u{i:04d}.wav"
        pcm = (3000.0 * rng.standard_normal(pcm_t)).astype(np.int16)
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
        lines.append(f"u{i:04d} {path}")
    (out / "wav.scp").write_text("\n".join(lines) + "\n")
    return str(out / "wav.scp")


def bench_frontend(extra: dict, device: str, batch: int = FRONTEND_BATCH,
                   seconds: float = FRONTEND_SECONDS,
                   rounds: int = FRONTEND_ROUNDS, n_utts: int = FEAT_UTTS,
                   utt_seconds: float = FRONTEND_SECONDS) -> None:
    """The batched fbank and MFCC on device-resident waveforms (one warm
    call, then `rounds` timed), then `feat`'s extract_split end to end
    (wav reads, device fbank, float64 CMVN, ark write) over `n_utts`
    seeded wavs: one warm pass, one timed."""
    from mdd_tpu_torch.frontend.fbank import FbankConfig, compute_fbank_batch
    from mdd_tpu_torch.frontend.mfcc import MfccConfig, compute_mfcc_batch
    from mdd_tpu_torch.frontend.pipeline import extract_split

    s = int(16000 * seconds)
    rng = np.random.default_rng(0)
    wav = torch.from_numpy(
        (3000.0 * rng.standard_normal((batch, s))).astype(np.float32)
    ).to(device)
    lengths = np.full((batch,), s, np.int32)
    for name, cfg_f, fn in (("fbank", FbankConfig(), compute_fbank_batch),
                            ("mfcc", MfccConfig(), compute_mfcc_batch)):
        fn(wav, lengths, cfg_f)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(rounds):
            fn(wav, lengths, cfg_f)
        _sync(device)
        elapsed = time.perf_counter() - t0
        extra[f"frontend_{name}_audio_s_per_s"] = round(
            rounds * batch * seconds / elapsed, 1)

    with tempfile.TemporaryDirectory() as d:
        out = Path(d)
        scp = write_wavs(out, n_utts, utt_seconds, rng)
        extract_split(scp, str(out / "feat0"), batch_size=batch,
                      device=device)                       # warm
        t0 = time.perf_counter()
        extract_split(scp, str(out / "feat1"), batch_size=batch,
                      device=device)
        elapsed = time.perf_counter() - t0
    extra["feat_split_audio_s_per_s"] = round(
        n_utts * utt_seconds / elapsed, 1)
    extra["feat_split_s_per_900_utts"] = round(elapsed, 2)


def _timed_passes(run, passes: int, n_utts: int) -> List[float]:
    """One warm pass of `run`, then `passes` timed; every pass must score
    `n_utts` utterances.  -> the timed passes' seconds."""
    times = []
    for i in range(passes + 1):
        t0 = time.perf_counter()
        rep = run()
        if i:
            times.append(time.perf_counter() - t0)
        if rep.n_utts != n_utts:
            raise RuntimeError(f"an evaluation pass scored {rep.n_utts} of "
                               f"{n_utts} utterances")
    return times


def trained_eval_state(cfg, vocab, device: str,
                       checkpoint_dir: str = EVAL_CHECKPOINT_DIR):
    """(state_dict, model config, tag) of bench.py's rule: the trained
    `best` of `checkpoint_dir` where it is present and its head has the
    vocabulary's classes, so the beam's blank skip fires as on real
    posteriors; else seeded random weights for `cfg` ("random_init",
    the case where the skip rarely fires).  A read error raises."""
    import dataclasses

    from mdd_tpu_torch.convert import flax_to_torch, random_flax_variables
    from mdd_tpu_torch.models.ctc_model import model_config_from_meta
    from mdd_tpu_torch.train.checkpoint import (checkpoint_format,
                                                load_checkpoint)

    if checkpoint_format(checkpoint_dir, "best") is not None:
        state, meta = load_checkpoint(checkpoint_dir, "best")
        model_cfg = model_config_from_meta(meta)
        if model_cfg.num_class == vocab.n_words:
            model_cfg = dataclasses.replace(
                model_cfg,
                use_pallas_lstm=torch.device(device).type == "cuda")
            return (state, model_cfg,
                    os.path.basename(os.path.normpath(checkpoint_dir))
                    + "/best")
    return flax_to_torch(*random_flax_variables(cfg, seed=0)), cfg, \
        "random_init"


def bench_eval(cfg, extra: dict, device: str, n_utts: int = EVAL_UTTS,
               batch: int = 128, cached_batch: int = 256,
               passes: int = EVAL_PASSES, beam_width: int = BEAM_WIDTH,
               workers: int = LOADER_WORKERS,
               checkpoint_dir: str = EVAL_CHECKPOINT_DIR) -> None:
    """`evaluate` end to end over `n_utts` seeded utterances (the syn_full
    test split where `n_utts` is 900): loader, device splice, forward,
    the device beam (the reference LM where there is one), the scorer
    thread, with the weights of `trained_eval_state`.  First through the
    streaming loader (raw bfloat16 wire, prefetch), then with the split
    resident on the device (attach_cache + CachedLoader); one warm pass
    and `passes` timed each.  On the local mesh the cards share every
    batch (the split's rows sharded over them in the cache); the rates
    are the whole split's, as bench.py's."""
    from mdd_tpu_torch.data.dataset import BucketedLoader, SpeechDataset
    from mdd_tpu_torch.data.device_cache import (CachedLoader,
                                                 DeviceFeatureCache)
    from mdd_tpu_torch.data.prefetch import ThreadedLoader
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.evals.evaluate import EvalSession, evaluate_model
    from mdd_tpu_torch.tools.synthetic_corpus import make_split

    phones = flagship_phones()
    lm_path = reference_lm()
    quiet = lambda *_: None
    with tempfile.TemporaryDirectory() as d:
        out = Path(d)
        make_split(out, "test", n_utts, seed=2, min_phones=16, max_phones=40,
                   phones=phones)
        vocab = Vocab(phones)
        state, model_cfg, tag = trained_eval_state(cfg, vocab, device,
                                                   checkpoint_dir)
        session = EvalSession(
            model_cfg, state, vocab, decode_type="beam",
            beam_width=beam_width, lm_path=lm_path, lm_alpha=0.5,
            device=device, device_frontend=True)
        ds = SpeechDataset(vocab, str(out / "test.scp"),
                           str(out / "test_phn_text"),
                           str(out / "test_transcript_phn_text"),
                           device_frontend=True)

        def streaming():
            loader = ThreadedLoader(
                BucketedLoader(ds, batch_size=batch, shuffle=False,
                               num_workers=workers, time_quantum=64,
                               wire_dtype="bfloat16", **_ranks()),
                prefetch=4)
            return evaluate_model(session, loader, log=quiet)

        times = _timed_passes(streaming, passes, n_utts)
        elapsed = float(np.mean(times))
        extra["eval_checkpoint"] = tag
        extra["eval_lm"] = lm_path
        extra["eval_n_utts"] = n_utts
        extra["eval_utts_per_s"] = round(n_utts / elapsed, 1)
        extra["eval_utts_per_s_min"] = round(n_utts / max(times), 1)
        extra["eval_utts_per_s_max"] = round(n_utts / min(times), 1)
        extra["eval_min_per_900_utts"] = round(elapsed / 60, 4)
        extra["eval_vs_reference_decode"] = round(
            REFERENCE_DECODE_MIN_900 / (elapsed / 60), 1)

        # repeated evaluation (per-epoch dev decoding): the split resident
        # on the device, a pass moves index vectors and labels only
        cache = DeviceFeatureCache(ds, device, time_quantum=64,
                                   wire_dtype="bfloat16", **_cache_ranks())
        session.attach_cache(cache)
        cloader = CachedLoader(cache, batch_size=cached_batch, shuffle=False,
                               **_ranks())
        times = _timed_passes(
            lambda: evaluate_model(session, cloader, log=quiet), passes,
            n_utts)
        extra["eval_utts_per_s_cached"] = round(
            n_utts / float(np.mean(times)), 1)
        extra["eval_utts_per_s_cached_max"] = round(n_utts / min(times), 1)


def _ranks() -> dict:
    """A loader's rank arguments: this rank's share of every global batch
    on the local mesh (split_batch), the whole batch in one process."""
    return dict(process_index=mesh.process_index(),
                process_count=mesh.process_count(),
                split_batch=mesh.local_mesh())


def _cache_ranks() -> dict:
    """A DeviceFeatureCache's: its rows sharded over the ranks."""
    return dict(process_index=mesh.process_index(),
                process_count=mesh.process_count())


def _epoch_rate(trainer, loader, epochs: int, audio_s: float) -> tuple:
    """One warm epoch, then `epochs` timed; -> (audio-s/s and card, s an
    epoch)."""
    quiet = lambda *_: None
    trainer.run_epoch(loader, epoch=0, train=True, log=quiet)
    t0 = time.perf_counter()
    for e in range(1, epochs + 1):
        trainer.run_epoch(loader, epoch=e, train=True, log=quiet)
    _sync(str(trainer.device))
    elapsed = time.perf_counter() - t0
    return epochs * audio_s / elapsed / n_cards(), elapsed / epochs


def bench_epoch(cfg, extra: dict, device: str, n_utts: int = EPOCH_UTTS,
                batch: int = 256, epochs: int = EPOCHS,
                workers: int = LOADER_WORKERS) -> None:
    """Training epochs over `n_utts` seeded utterances of 16-40 phones
    (the reference's ~3 s length statistics, the flagship's units),
    input pipeline included: on the device-resident corpus (uploaded
    once; a batch is gathered and masked on the device), then on the
    streaming loader (ark reads, host SpecAugment and mutation, bucketed
    batches, raw bfloat16 wire, splice on the device).  One warm epoch
    and `epochs` timed on each; writing the corpus is timed apart.  The
    cards share every batch (the corpus's rows sharded over them); the
    rates are a card's, as bench.py's."""
    from mdd_tpu_torch.data.dataset import BucketedLoader, SpeechDataset
    from mdd_tpu_torch.data.device_cache import (CachedLoader,
                                                 DeviceFeatureCache)
    from mdd_tpu_torch.data.prefetch import ThreadedLoader
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.tools.synthetic_corpus import make_split
    from mdd_tpu_torch.train.loop import Trainer

    phones = flagship_phones()
    if len(phones) + 2 != cfg.num_class:
        raise ValueError(f"{len(phones)} units for a {cfg.num_class}-class "
                         "head: the epoch corpus must match the flagship's")
    with tempfile.TemporaryDirectory() as d:
        out = Path(d)
        t0 = time.perf_counter()
        make_split(out, "train", n_utts, seed=0, min_phones=16,
                   max_phones=40, phones=phones)
        extra["epoch_corpus_s"] = round(time.perf_counter() - t0, 1)
        vocab = Vocab(phones)
        ds = SpeechDataset(vocab, str(out / "train.scp"),
                           str(out / "train_phn_text"),
                           str(out / "train_transcript_phn_text"),
                           train=True, device_frontend=True)
        trainer = Trainer(cfg, device=device, device_frontend=True)
        cache = DeviceFeatureCache(ds, device, wire_dtype="bfloat16",
                                   **_cache_ranks())
        audio_s = float(cache.lengths.sum()) * 0.01
        extra["epoch_model_num_class"] = cfg.num_class
        extra["epoch_audio_s"] = round(audio_s, 1)

        cloader = CachedLoader(cache, batch_size=batch, shuffle=True, seed=0,
                               **_ranks())
        rate, secs = _epoch_rate(trainer, cloader, epochs, audio_s)
        extra["epoch_audio_s_per_s_cached"] = round(rate, 1)
        extra["epoch_s_cached"] = round(secs, 3)
        extra["cache_mb"] = round(cache.bytes / 2 ** 20, 1)
        extra["cache_mb_per_device"] = round(cache.bytes_per_device / 2 ** 20,
                                             1)

        loader = ThreadedLoader(
            BucketedLoader(ds, batch_size=batch, shuffle=True, seed=0,
                           num_workers=workers, wire_dtype="bfloat16",
                           **_ranks()),
            prefetch=4)
        rate, secs = _epoch_rate(trainer, loader, epochs, audio_s)
        extra["epoch_audio_s_per_s_with_pipeline"] = round(rate, 1)
        extra["epoch_s"] = round(secs, 3)


def _section(name: str, fn, *args, one_card: bool = False):
    """fn(*args), its wall time on stderr (rank 0's); -> what fn returns.
    `one_card`: on rank 0 alone, the others waiting for it."""
    t0 = time.perf_counter()
    got = None
    if not one_card or mesh.process_index() == 0:
        got = fn(*args)
    if one_card:
        mesh.barrier()
    if mesh.process_index() == 0:
        print(f"[benchmark] {name} in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return got


def main(device: str = "cuda") -> dict:
    """Run the five sections in bench.py's order and print its one JSON
    line (rank 0); -> the line's object.  Raises SystemExit under
    torchrun with several processes, and for a CUDA device on a host
    without one."""
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1 and not mesh.local_mesh():
        raise SystemExit(f"benchmark starts a rank on every card of this "
                         f"host itself; it does not run as one of "
                         f"WORLD_SIZE={world} ranks (run it without "
                         "torchrun)")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"benchmark --device {device}: this host has no "
                         "CUDA device (pass --device cpu to run on the CPU)")
    cfg = flagship_config(device)
    extra: dict = {"model_num_class": cfg.num_class,
                   "card": card_line(device), "n_cards": n_cards()}
    value = _section("train", bench_train, cfg, extra, device)
    _section("decode", bench_decode, extra, device, one_card=True)
    _section("frontend", bench_frontend, extra, device, one_card=True)
    _section("eval", bench_eval, cfg, extra, device)
    _section("epoch", bench_epoch, cfg, extra, device)
    line = {
        "metric": "train_throughput_audio_seconds_per_s_per_chip",
        "value": round(value, 2),
        "unit": "audio_s/s/chip",
        "vs_baseline": round(value / BASELINE_AUDIO_SEC_PER_S, 3),
        "extra": extra,
    }
    if mesh.process_index() == 0:
        print(json.dumps(line), flush=True)
    return line
