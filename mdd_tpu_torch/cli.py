"""Command-line interface of the port (counterpart of mdd_tpu/cli.py).

  python -m mdd_tpu_torch prepare-timit --timit-dir D --out D
                                [--speakers-file F] [--phoneme-map 60-41]
  python -m mdd_tpu_torch prepare-l2arctic --l2-dir D --out-root D
                                [--fold-reduced]
  python -m mdd_tpu_torch merge --dirs D [D ...] --out D
  python -m mdd_tpu_torch units --phn-text F --out F
  python -m mdd_tpu_torch feat --wav-scp F --out-dir D
                                [--feat-type fbank|mfcc|spectrogram]
                                [--name N] [--cmvn F] [--batch-size N]
                                [--device cuda|cpu]
  python -m mdd_tpu_torch train --conf YAML [--resume] [--device cuda|cpu]
                                [--distributed] [--profile-dir DIR]
  python -m mdd_tpu_torch evaluate --conf YAML [--checkpoint DIR]
                                [--dump-dir DIR] [--decode-type Greedy|Beam]
                                [--lm-alpha A] [--cached] [--distributed]
                                [--device cuda|cpu]
  python -m mdd_tpu_torch mdd-result --ref F --human F --hyp F
                                [--detail-dir DIR]
  python -m mdd_tpu_torch train-lm --phn-text F --out ARPA
  python -m mdd_tpu_torch infer --wav-transcript-path DIR --conf YAML
                                --cmvn F [--checkpoint DIR] [--dict-dir DIR]
                                [--ecdict-csv F] [--forgiving 0|1|2]
                                [--phonetic-format cmu|ipa]
                                [--textgrid-path DIR] [--decode-dump F]
                                [--[no-]denoise] [--device cuda|cpu]
  python -m mdd_tpu_torch serve --conf YAML --cmvn F [--checkpoint DIR]
                                [--dict-dir DIR] [--ecdict-csv F]
                                [--forgiving 0|1|2] [--phonetic-format cmu|ipa]
                                [--warmup [SECONDS]] [--max-batch N]
                                [--socket HOST:PORT|PATH] [--[no-]denoise]
                                [--device cuda|cpu] [--decode-type Greedy|Beam]
  python -m mdd_tpu_torch benchmark [--device cuda|cpu]

`prepare-timit`, `prepare-l2arctic`, `merge` and `units` write the
Kaldi-style data dirs and the unit inventory (data/prepare.py).  `feat`
extracts fbank or MFCC features of a wav.scp on the device to
`<out-dir>/<name>.{ark,scp}`, CMVN-normalized with `--cmvn`'s stats or
with stats trained on this split (written to
`global_<name>_cmvn.txt`), or the per-utterance normalized spectrogram,
which has no CMVN stage.  `train`
runs the recipe of the YAML, on the device-resident corpus where
it says `device_cache: true` (train and dev split) and on the streaming
loader otherwise, and writes `best` and the resumable `latest` under
`<checkpoint_dir>/<exp_name>/`.  `evaluate` decodes the YAML's test split
with `best` (greedy, or the batched beam with the bigram LM of `lm_path`
weighted by `lm_alpha`), prints PER and the TA/FR/FA/TR report and, with
`--dump-dir`, writes the decode_seq / human_seq / transcribe files that
`mdd-result` scores; `--cached` puts the test split on the device first.
`train-lm` trains that bigram LM from a phone transcript file.
`train`, `evaluate` and `benchmark` run on the host's cards as mdd_tpu
runs on its local mesh: `train` on `data_parallel` of them (0 every
visible card, N the first N), `evaluate` and `benchmark` on every one;
with more than one the command starts a rank a card itself (nccl;
parallel/launch.py), `batch_size` counting the rows of the global batch
that the ranks share, and prints one card's output (`evaluate` one set
of dumps).  `--device cuda:K` is card K alone; on the CPU (`--device
cpu`) `data_parallel: N` starts N ranks (gloo).  `serve` and `infer`
answer on one card.  With `--distributed`, `train` and `evaluate` are one
rank of a multi-host run (`torchrun --nproc-per-node N -m mdd_tpu_torch
train --conf YAML --distributed`): each rank on its own card where there
are enough (nccl), else sharing them (gloo), `batch_size` counting each
rank's rows; every rank prints the same losses and reports.
`infer` diagnoses every N.wav + N.txt prompt pair of a directory and
prints a report per word and the RTF breakdown; `serve` answers
line-delimited JSON requests on stdin, or with `--socket` on a loopback
TCP address or a unix-socket path for concurrent clients (see serve.py).
Both take the canonical phones, IPA, translation and phonics from the
lexicon: the CMUdict files of `--dict-dir` (else MDD_DICT_DIR) and the
ECDICT csv of `--ecdict-csv`, and both denoise every wav with the native
denoiser unless given `--no-denoise`; where the denoiser does not build
they fail (mdd_tpu warns and goes on without it).
`benchmark` measures mdd_tpu's bench.py sections (bench.py): the train
step's audio-s/s and MFU, the device beam, the front end, `evaluate` and
whole epochs, and prints one JSON line.
The checkpoint is `best` under `<checkpoint_dir>/<exp_name>/` of the
config, or under `--checkpoint`: the port's `best.pt` + `best.meta.json`
(train/checkpoint.py), or mdd_tpu's orbax directory `best/` beside
`best.meta.json`, read without JAX (train/orbax_format.py).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import List, Optional


def cmd_prepare_timit(args) -> int:
    from mdd_tpu_torch.data.prepare import prepare_timit

    speakers = None
    if args.speakers_file:
        with open(args.speakers_file) as f:
            speakers = [l.strip() for l in f if l.strip()]
    n = prepare_timit(args.timit_dir, args.out, speakers=speakers,
                      phoneme_map=args.phoneme_map)
    print(f"prepared {n} TIMIT utterances -> {args.out}")
    return 0


def cmd_prepare_l2arctic(args) -> int:
    from mdd_tpu_torch.data.prepare import prepare_l2arctic

    for split in ("train", "dev", "test"):
        out = f"{args.out_root}/l2_{split}"
        n = prepare_l2arctic(args.l2_dir, out, split,
                             keep_reduced=not args.fold_reduced)
        print(f"prepared {n} L2-ARCTIC {split} utterances -> {out}")
    return 0


def cmd_merge(args) -> int:
    from mdd_tpu_torch.data.prepare import merge_data_dirs

    merge_data_dirs(args.dirs, args.out)
    print(f"merged {len(args.dirs)} dirs -> {args.out}")
    return 0


def cmd_units(args) -> int:
    from mdd_tpu_torch.data.prepare import build_units

    units = build_units(args.phn_text, args.out)
    print(f"{len(units)} units -> {args.out}")
    return 0


def cmd_feat(args) -> int:
    from pathlib import Path

    from mdd_tpu_torch.frontend.cmvn import parse_kaldi_cmvn_text
    from mdd_tpu_torch.frontend.pipeline import extract_split

    if args.feat_type == "spectrogram":
        # the legacy spectrogram path has no CMVN stage
        if args.cmvn:
            raise SystemExit(
                "--cmvn is not supported with --feat-type spectrogram: the "
                "legacy spectrogram path (local/make_spectrum.py) has no "
                "CMVN stage, so the stats would be silently ignored.  Use "
                "fbank or mfcc for CMVN-normalized features.")
        from mdd_tpu_torch.frontend.spectrogram import make_spectrum

        out = Path(args.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        name = args.name if args.name != "fbank" else "spectrogram"
        scp_path = str(out / f"{name}.scp")
        make_spectrum(args.wav_scp, str(out / f"{name}.ark"), scp_path,
                      device=args.device)
        print(f"features -> {scp_path}")
        return 0
    if args.feat_type == "mfcc":
        from mdd_tpu_torch.frontend.mfcc import MfccConfig

        cfg = MfccConfig()
        name = args.name if args.name != "fbank" else "mfcc"
    else:
        from mdd_tpu_torch.frontend.fbank import FbankConfig

        cfg = FbankConfig()
        name = args.name
    cmvn = parse_kaldi_cmvn_text(args.cmvn) if args.cmvn else None
    scp_path, _ = extract_split(args.wav_scp, args.out_dir, name=name,
                                cfg=cfg, cmvn=cmvn,
                                batch_size=args.batch_size,
                                device=args.device)
    print(f"features -> {scp_path}")
    return 0


def _build_loader(cfg, vocab, scp, lab, trans, train: bool,
                  device: str = "cuda", global_schedule: Optional[bool] = None):
    """mdd_tpu's `_build_loader`: the device-resident corpus on `device`
    where the config says `device_cache` (its rows sharded over the
    ranks), else the streaming loader; both yield this rank's rows of
    each batch, a share of the global batch on a local mesh.
    `global_schedule`: the streaming loader's (None: on with several
    processes; a local mesh's ranks always share its batches)."""
    from mdd_tpu_torch.data.dataset import BucketedLoader, SpeechDataset
    from mdd_tpu_torch.data.prefetch import ThreadedLoader
    from mdd_tpu_torch.parallel import mesh

    ds = SpeechDataset(
        vocab, scp, lab, trans,
        left_ctx=cfg.left_ctx, right_ctx=cfg.right_ctx,
        n_skip_frame=cfg.n_skip_frame, n_downsample=cfg.n_downsample,
        train=train, augment_mode=cfg.augment_mode,
        mutation_prob=cfg.mutation_prob,
        device_frontend=cfg.device_frontend)
    split = mesh.local_mesh()
    ranks = dict(process_index=mesh.process_index(),
                 process_count=mesh.process_count())
    if cfg.device_frontend and cfg.device_cache:
        from mdd_tpu_torch.data.device_cache import (CachedLoader,
                                                     DeviceFeatureCache)

        # the streaming branch's wire dtype (unset: float32), so both
        # paths give one config the same features
        cache = DeviceFeatureCache(ds, device, time_quantum=cfg.time_quantum,
                                   wire_dtype=cfg.wire_dtype or "float32",
                                   **ranks)
        return CachedLoader(cache, cfg.batch_size,
                            shuffle=train and cfg.shuffle_train,
                            seed=cfg.seed, label_quantum=cfg.label_quantum,
                            split_batch=split, **ranks)
    loader = BucketedLoader(
        ds, cfg.batch_size, shuffle=train and cfg.shuffle_train,
        seed=cfg.seed, num_workers=cfg.num_workers,
        time_quantum=cfg.time_quantum, label_quantum=cfg.label_quantum,
        wire_dtype=(cfg.wire_dtype or None) if cfg.device_frontend else None,
        global_schedule=None if split else global_schedule,
        split_batch=split, **ranks)
    if cfg.num_workers > 0:
        loader = ThreadedLoader(loader, prefetch=4)
    return loader


@contextlib.contextmanager
def _rank(args, out=None):
    """-> the device of this process; with --distributed, or as a rank of
    the local mesh (parallel/launch.py), as one rank of the process group
    (mesh.joined), its line printed to `out` (stdout)."""
    from mdd_tpu_torch.parallel import mesh

    if not (getattr(args, "distributed", False) or mesh.launched_locally()):
        yield args.device
        return
    with mesh.joined(args.device) as device:
        print(mesh.describe(device), file=out or sys.stdout, flush=True)
        yield str(device)


def build_trainer(cfg, vocab, device: str, **model_overrides):
    """The Trainer of the YAML's recipe.  `model_overrides` replace
    ModelConfig fields no YAML key sets (`use_fused_dropout`, as in
    mdd_tpu, where it is reached through ModelConfig only)."""
    import dataclasses

    from mdd_tpu_torch.utils import trace

    with trace.span("setup.trainer"):
        from mdd_tpu_torch.train.loop import Trainer

        return Trainer(
            dataclasses.replace(cfg.model_config(vocab.n_words),
                                **model_overrides),
            init_lr=cfg.init_lr, weight_decay=cfg.weight_decay,
            lr_decay=cfg.lr_decay, end_adjust_acc=cfg.end_adjust_acc,
            plateau_patience=cfg.plateau_patience,
            max_adjust_times=cfg.max_adjust_times, seed=cfg.seed,
            device=device, device_frontend=cfg.device_frontend,
            left_ctx=cfg.left_ctx, right_ctx=cfg.right_ctx,
            n_skip_frame=cfg.n_skip_frame, n_downsample=cfg.n_downsample)


def cmd_train(args) -> int:
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.utils.config import (check_distributed_width,
                                            load_config)

    cfg = load_config(args.conf)
    if args.distributed and os.environ.get("WORLD_SIZE"):
        check_distributed_width(cfg, int(os.environ["WORLD_SIZE"]))
    with _rank(args) as device:
        vocab = Vocab.from_units_file(cfg.vocab_file)
        print(f"Vocabulary size is {vocab.n_words}")
        # the profile holds the set-up too: the Trainer's and the
        # loaders' builds (setup.trainer, setup.device_cache)
        with _profiled(args.profile_dir, device):
            trainer = build_trainer(cfg, vocab, device)
            schedule = True if cfg.global_schedule else None
            train_loader = _build_loader(
                cfg, vocab, cfg.train_scp_path, cfg.train_lab_path,
                cfg.train_trans_path, train=True, device=device,
                global_schedule=schedule)
            dev_loader = _build_loader(
                cfg, vocab, cfg.valid_scp_path, cfg.valid_lab_path,
                cfg.valid_trans_path, train=False, device=device,
                global_schedule=schedule)
            summary = trainer.fit(train_loader, dev_loader,
                                  num_epochs=cfg.num_epoches,
                                  print_every=cfg.verbose_step,
                                  checkpoint_dir=cfg.checkpoint_dir,
                                  exp_name=cfg.exp_name, resume=args.resume,
                                  checkpoint_every=cfg.checkpoint_every)
    print("best dev loss %.4f acc %.4f after %d epochs"
          % (summary["best_dev_loss"], summary["best_acc"],
             summary["epochs"]))
    return 0


@contextlib.contextmanager
def _profiled(profile_dir: Optional[str], device: str):
    """torch.profiler over the block, its trace written to
    `<profile_dir>/trace_rank<r>.json` (mdd_tpu's `--profile-dir`: a device
    trace of the whole run, its set-up included, with the program's spans,
    utils/trace.py, on while the profiler records); nothing without a
    directory."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mdd_tpu_torch.parallel import mesh

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir,
                        f"trace_rank{mesh.process_index()}.json")
    prof.export_chrome_trace(path)
    print(f"profile -> {path}")


def cmd_train_lm(args) -> int:
    from mdd_tpu_torch.decode.lm_train import train_phone_lm

    n = train_phone_lm(args.phn_text, args.out)
    print(f"trained bigram LM on {n} sentences -> {args.out}")
    return 0


def _load_best(cfg, checkpoint: Optional[str]):
    """-> (state_dict, ModelConfig) of the experiment's `best`, the port's
    or mdd_tpu's (orbax).  `checkpoint` is the directory that holds it, as
    in mdd_tpu, or `best` itself (`checkpoints/syn_full/best`)."""
    from mdd_tpu_torch.models.ctc_model import model_config_from_meta
    from mdd_tpu_torch.train.checkpoint import (checkpoint_format,
                                                load_checkpoint)

    ckpt_dir = checkpoint or os.path.join(cfg.checkpoint_dir, cfg.exp_name)
    head, tail = os.path.split(os.path.normpath(ckpt_dir))
    if (tail == "best" and checkpoint_format(ckpt_dir, "best") is None
            and checkpoint_format(head, "best") is not None):
        ckpt_dir = head
    state, meta = load_checkpoint(ckpt_dir, "best")
    return state, model_config_from_meta(meta)


def cmd_evaluate(args) -> int:
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.evals.evaluate import EvalSession, evaluate_model
    from mdd_tpu_torch.parallel import mesh
    from mdd_tpu_torch.utils.config import load_config

    cfg = load_config(args.conf)
    # `--cached` is opt-in, not inferred from the YAML's device_cache: a
    # one-shot evaluation pays the upload before the first batch, where
    # the streaming loader overlaps reading and decoding
    if args.cached and not cfg.device_frontend:
        raise SystemExit("evaluate --cached requires device_frontend: true "
                         "in the config")
    with _rank(args) as device:
        if args.cached and args.distributed and mesh.process_count() > 1:
            # mdd_tpu warns and falls back to the streaming loader
            raise SystemExit("evaluate --cached runs on one host; with "
                             "--distributed each rank decodes its share "
                             "through the streaming loader: drop --cached")
        cfg.device_cache = args.cached
        if args.decode_type:
            cfg.decode_type = args.decode_type
        if args.lm_alpha is not None:
            cfg.lm_alpha = args.lm_alpha
        vocab = Vocab.from_units_file(cfg.vocab_file)
        state, model_cfg = _load_best(cfg, args.checkpoint)
        # device-frontend eval: raw bf16 features on the wire, splice/skip
        # on the device before the forward, as in training
        session = EvalSession(
            model_cfg, state, vocab, decode_type=cfg.decode_type,
            beam_width=cfg.beam_width, lm_path=cfg.lm_path or None,
            lm_alpha=cfg.lm_alpha, device=device,
            device_frontend=cfg.device_frontend,
            left_ctx=cfg.left_ctx, right_ctx=cfg.right_ctx,
            n_skip_frame=cfg.n_skip_frame, n_downsample=cfg.n_downsample)
        # --distributed: each rank its own share of the split, decoded
        # alone (no collective until the report), so no global schedule;
        # a local mesh's ranks share every batch instead
        loader = _build_loader(cfg, vocab, cfg.test_scp_path,
                               cfg.test_lab_path, cfg.test_trans_path,
                               train=False, device=device,
                               global_schedule=False)
        if args.cached:
            session.attach_cache(loader.cache)
        evaluate_model(session, loader, dump_dir=args.dump_dir)
    return 0


def cmd_mdd_result(args) -> int:
    """Score decode dumps: the result/mdd_result.sh:6-13 pipeline
    (compute-wer PER report + 3-way hierarchical MDD analysis) over trn
    files as produced by `evaluate --dump-dir`."""
    from mdd_tpu_torch.evals.analysis import mdd_result
    from mdd_tpu_torch.evals.wer import read_trn

    mdd_result(read_trn(args.ref), read_trn(args.human),
               read_trn(args.hyp), out_dir=args.detail_dir)
    return 0


def _build_engine(args):
    """The InferenceEngine of `infer` and `serve`: the experiment's `best`,
    the YAML's decoder and front end, and the lexicon of --dict-dir."""
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.frontend.cmvn import parse_kaldi_cmvn_text
    from mdd_tpu_torch.infer import InferenceEngine
    from mdd_tpu_torch.lexicon.dictionary import Phonetic
    from mdd_tpu_torch.utils.config import load_config

    cfg = load_config(args.conf)
    if args.decode_type:
        cfg.decode_type = args.decode_type
    state, model_cfg = _load_best(cfg, args.checkpoint)
    denoiser = None
    if args.denoise:
        # the demo's denoise stage, on every wav; mdd_tpu goes on without
        # it when its library does not build, the port stops
        from mdd_tpu_torch import native

        try:
            native.load_denoiser()
        except (RuntimeError, OSError) as e:
            raise SystemExit(f"the native denoiser is unavailable ({e}); "
                             "pass --no-denoise to run without it") from e
        denoiser = native.spectral_denoise
    return InferenceEngine(
        model_cfg, state,
        Vocab.from_units_file(cfg.vocab_file),
        cmvn=parse_kaldi_cmvn_text(args.cmvn),
        phonetic=Phonetic(asset_dir=args.dict_dir,
                          ecdict_csv=args.ecdict_csv),
        decode_type=cfg.decode_type, beam_width=cfg.beam_width,
        lm_path=cfg.lm_path or None, lm_alpha=cfg.lm_alpha,
        left_ctx=cfg.left_ctx, right_ctx=cfg.right_ctx,
        n_skip_frame=cfg.n_skip_frame, n_downsample=cfg.n_downsample,
        use_ipa=args.phonetic_format == "ipa", forgiving=args.forgiving,
        device=args.device, denoiser=denoiser)


def cmd_infer(args) -> int:
    """The single-word diagnosis demo over N.wav + N.txt pairs."""
    engine = _build_engine(args)
    engine.diagnose_dir(args.wav_transcript_path,
                        textgrid_dir=args.textgrid_path,
                        decode_dump=args.decode_dump)
    return 0


def cmd_serve(args) -> int:
    """Load the model and the lexicon once, answer JSON request lines on
    stdin until EOF, or on `--socket` until interrupted."""
    from mdd_tpu_torch.serve import SocketServer, serve_loop

    engine = _build_engine(args)
    if args.warmup:
        n_shapes = engine.warmup(max_seconds=args.warmup)
        print(f"warmed {n_shapes} shapes", file=sys.stderr, flush=True)
    log = (None if args.quiet else
           (lambda m: print(m, file=sys.stderr, flush=True)))
    if args.socket:
        server = SocketServer(engine, args.socket, max_batch=args.max_batch,
                              log=log)
        addr = (f"port {server.port}" if server.port is not None
                else args.socket)
        print(f"ready on {addr}", file=sys.stderr, flush=True)
        try:
            n = server.serve_forever()
        except KeyboardInterrupt:
            n = server.n_served
    else:
        print("ready", file=sys.stderr, flush=True)
        n = serve_loop(engine, sys.stdin, sys.stdout, log=log,
                       max_batch=args.max_batch)
    print(f"served {n} requests in {engine.session.forwards} forwards",
          file=sys.stderr)
    return 0


def cmd_benchmark(args) -> int:
    from mdd_tpu_torch import bench

    # stdout holds the one JSON line
    with _rank(args, out=sys.stderr) as device:
        bench.main(device=device)
    return 0


def _add_lexicon_args(q) -> None:
    """The flags `infer` and `serve` share: model, lexicon and display."""
    q.add_argument("--conf", required=True)
    q.add_argument("--checkpoint",
                   help="directory holding best (the port's best.pt + "
                        "best.meta.json or mdd_tpu's orbax best/), or that "
                        "best/ itself (default: <checkpoint_dir>/<exp_name>)")
    q.add_argument("--cmvn", required=True)
    q.add_argument("--dict-dir",
                   help="directory of cmudict.dict and cmudict-0.7b-ipa.txt "
                        "(and optionally phonics_engine.csv); default "
                        "$MDD_DICT_DIR")
    q.add_argument("--ecdict-csv",
                   help="ECDICT csv for Chinese word translations")
    q.add_argument("--forgiving", type=int, choices=[0, 1, 2],
                   default=None,
                   help="forgive confusable-phone substitutions at this "
                        "level (off by default: the strict criterion)")
    q.add_argument("--phonetic-format", choices=["cmu", "ipa"],
                   default="cmu",
                   help="show the canonical and decoded rows in CMU units "
                        "or IPA symbols")
    q.add_argument("--denoise", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run the native denoiser on every wav (default on, "
                        "as the reference demo denoises every input); "
                        "--no-denoise disables it")
    q.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mdd_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    q = sub.add_parser("prepare-timit", help="TIMIT -> data dir")
    q.add_argument("--timit-dir", required=True)
    q.add_argument("--out", required=True)
    q.add_argument("--speakers-file",
                   help="keep only these speakers (one id a line)")
    q.add_argument("--phoneme-map", default="60-41",
                   choices=["60-41", "60-48", "48-39"])
    q.set_defaults(fn=cmd_prepare_timit)

    q = sub.add_parser("prepare-l2arctic", help="L2-ARCTIC -> data dirs")
    q.add_argument("--l2-dir", required=True)
    q.add_argument("--out-root", required=True)
    q.add_argument("--fold-reduced", action="store_true",
                   help="fold ah0/er0 into ah/er (39-phone recipe)")
    q.set_defaults(fn=cmd_prepare_l2arctic)

    q = sub.add_parser("merge", help="merge data dirs")
    q.add_argument("--dirs", nargs="+", required=True)
    q.add_argument("--out", required=True)
    q.set_defaults(fn=cmd_merge)

    q = sub.add_parser("units", help="build modelling units")
    q.add_argument("--phn-text", required=True)
    q.add_argument("--out", required=True)
    q.set_defaults(fn=cmd_units)

    q = sub.add_parser("feat", help="extract acoustic features")
    q.add_argument("--wav-scp", required=True)
    q.add_argument("--out-dir", required=True)
    q.add_argument("--feat-type", default="fbank",
                   choices=["fbank", "mfcc", "spectrogram"],
                   help="feature type (the reference runner's feat_type)")
    q.add_argument("--name", default="fbank",
                   help="file stem (default fbank; mfcc and spectrogram "
                        "when left at fbank for those types)")
    q.add_argument("--cmvn", help="existing CMVN stats (else trained here)")
    q.add_argument("--batch-size", type=int, default=16)
    q.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    q.set_defaults(fn=cmd_feat)

    q = sub.add_parser("train", help="train the CTC-attention model")
    q.add_argument("--conf", required=True)
    q.add_argument("--resume", action="store_true",
                   help="continue from the experiment's 'latest' "
                        "checkpoint (params, optimizer, LR scheduler and "
                        "loss histories are restored): the port's "
                        "latest.pt, or mdd_tpu's orbax latest/, whose "
                        "optax Adam state becomes torch's and whose format "
                        "the run's later latest and best keep; without a "
                        "latest the run starts afresh")
    q.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda)")
    q.add_argument("--distributed", action="store_true",
                   help="one rank of a data-parallel run: join the process "
                        "group of torchrun's environment (RANK, WORLD_SIZE, "
                        "LOCAL_RANK, MASTER_ADDR, MASTER_PORT); batch_size "
                        "counts this rank's rows")
    q.add_argument("--profile-dir",
                   help="write a torch.profiler trace of the run here, one "
                        "file a rank")
    q.set_defaults(fn=cmd_train)

    q = sub.add_parser("evaluate", help="MDD evaluation on the test set")
    q.add_argument("--conf", required=True)
    q.add_argument("--checkpoint",
                   help="directory holding best (the port's best.pt + "
                        "best.meta.json or mdd_tpu's orbax best/), or that "
                        "best/ itself (default: <checkpoint_dir>/<exp_name>)")
    q.add_argument("--dump-dir",
                   help="write decode_seq.log, human_seq.log and "
                        "transcribe.log here (mdd-result's inputs)")
    q.add_argument("--decode-type", dest="decode_type",
                   help="override the config's decode_type (e.g. Greedy "
                        "vs Beam for ablation runs)")
    q.add_argument("--lm-alpha", dest="lm_alpha", type=float,
                   help="override the config's LM fusion weight "
                        "(0 disables the LM term in the beam)")
    q.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    q.add_argument("--cached", action="store_true",
                   help="put the test split's features on the device "
                        "first and form each batch there (needs "
                        "device_frontend)")
    q.add_argument("--distributed", action="store_true",
                   help="one rank of a multi-process evaluation (torchrun's "
                        "environment): each rank decodes its share of the "
                        "test split, every rank prints the summed report")
    q.set_defaults(fn=cmd_evaluate)

    q = sub.add_parser("mdd-result",
                       help="score decode dumps (mdd_result.sh pipeline)")
    q.add_argument("--ref", required=True,
                   help="canonical phones trn (transcribe.log)")
    q.add_argument("--human", required=True,
                   help="human-annotated phones trn (human_seq.log)")
    q.add_argument("--hyp", required=True,
                   help="decoded phones trn (decode_seq.log)")
    q.add_argument("--detail-dir",
                   help="emit Kaldi-format *_detail alignment files here")
    q.set_defaults(fn=cmd_mdd_result)

    q = sub.add_parser("train-lm", help="train bigram phone LM")
    q.add_argument("--phn-text", required=True)
    q.add_argument("--out", required=True)
    q.set_defaults(fn=cmd_train_lm)

    q = sub.add_parser("infer", help="single-word diagnosis demo over "
                                     "N.wav + N.txt prompt pairs")
    q.add_argument("--wav-transcript-path", required=True)
    _add_lexicon_args(q)
    q.add_argument("--textgrid-path",
                   help="canonical phones from N.TextGrid files here "
                        "instead of the lexicon")
    q.add_argument("--decode-dump",
                   help="write one 'N decoded phones' line per pair here")
    q.set_defaults(fn=cmd_infer, decode_type=None)

    q = sub.add_parser("serve", help="persistent diagnosis server "
                                     "(line-delimited JSON on stdin)")
    _add_lexicon_args(q)
    q.add_argument("--decode-type", dest="decode_type",
                   help="override the config's decode_type (Greedy, or "
                        "anything else for the beam)")
    q.add_argument("--warmup", type=float, nargs="?", const=3.2,
                   default=0.0, metavar="SECONDS",
                   help="run the serving shape set for wavs up to SECONDS "
                        "(default 3.2) before the first request")
    q.add_argument("--socket", metavar="ADDR",
                   help="listen on 'host:port' (TCP, a loopback host only) "
                        "or a unix-socket path instead of stdin/stdout; "
                        "concurrent clients are batched together")
    q.add_argument("--max-batch", type=int, default=16,
                   help="requests answered together, at most (default 16)")
    q.add_argument("--quiet", action="store_true",
                   help="no per-request log lines on stderr")
    q.set_defaults(fn=cmd_serve)

    q = sub.add_parser("benchmark", help="training-throughput benchmark "
                                         "(one JSON line)")
    q.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    q.set_defaults(fn=cmd_benchmark)
    return p


# the subcommands that run on mdd_tpu's local mesh; `serve` and `infer`
# answer a request on one card (a batch-1 request gains nothing from
# being padded to the mesh, as mdd_tpu's EvalSession would pad it)
LOCAL_MESH_COMMANDS = ("train", "evaluate", "benchmark")


def local_width(args) -> int:
    """The ranks a LOCAL_MESH_COMMANDS command runs as on this host
    (parallel/launch.local_width): `train` `data_parallel` cards,
    `evaluate` and `benchmark` every visible card, as mdd_tpu's
    make_local_mesh; on the CPU `data_parallel` ranks for `train` and
    `evaluate`, one for `benchmark`, which reads no config."""
    from mdd_tpu_torch.parallel.launch import local_width as width
    from mdd_tpu_torch.utils.config import load_config

    if args.command == "benchmark":
        return width(0, args.device, every_card=True)
    cfg = load_config(args.conf)
    return width(cfg.data_parallel, args.device,
                 every_card=args.command == "evaluate")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if (args.command in LOCAL_MESH_COMMANDS
            and not getattr(args, "distributed", False)):
        from mdd_tpu_torch.parallel import launch, mesh

        if mesh.launched_locally():
            launch.follow_launcher()          # a rank of the local mesh
        else:
            n = local_width(args)
            if n > 1:
                return launch.launch_local(
                    sys.argv[1:] if argv is None else list(argv), n,
                    args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
