"""Drive the PyTorch + CUDA port (mdd_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py            # from the repo root, on a machine with a card

Phases, each printed as it ends; any failure raises and exits non-zero.
A float32 forward of the flagship model launches lstm_fwd 5 times (4
acoustic BiLSTM layers and the text BiLSTM) and its train step lstm_bwd 5
times; in bfloat16 the text BiLSTM runs on the scan-contract kernels
(lstm_fwd and lstm_bwd 4 each, lstm_scan_fwd once a forward and
lstm_scan_bwd once a train step):


1. build    nvcc every CUDA source of the port for sm_90a (in parallel):
            lstm_fwd.cu, lstm_bwd.cu, lstm_scan.cu (the scan contract's
            kernels), dropout.cu, wer.cu, ctc_beam.cu,
            ctc_loss.cu and mma_rate.cu (the
            mma.sync-rate yardstick of ops/mma_rate.py, no kernel of
            the model's path), the skeleton builds of ctc_beam.cu,
            ctc_loss.cu and wer.cu (the chain floors) and the parent
            tree's three (PARENT_TREE, where there is one); g++ the host
            C++ sources at
            the same time: denoise.cc (the denoiser library and the
            mdd_denoise tool) and ark_io.cc (the mmap ark reader).
2. kernel   lstm_fwd against its plain PyTorch version on the card, at the
            serving and training shapes (H=384, B in {1, 4, 16, 64}, T' in
            {16, 80, 128}), at B=24, 256 and 512 (two unit groups a
            block, four and eight launches) and at phase benchmark's
            (B, T') of BENCH_SHAPES, float32 and bfloat16.
3. kernel-bwd  lstm_bwd against its plain version at the training shapes
            (H=384, B in {1, 4, 16, 24, 64}, T' in {16, 80, 128}), at
            B=256, 300 and 512 (each as several recurrence launches, 300
            with a ragged last one; the same bits twice) and at
            BENCH_SHAPES, float32 and bfloat16.
3a. kernel-staging  both LSTM kernels launched 200 times each at B=1
            while a thread puts small host arrays on the card, as
            evaluate's staging thread does: every launch's bits equal the
            first's, and the thread's tensors hold what it put there
            (the barrier counters stay a launch's own until it is
            enqueued).
3b. kernel-wer  greedy_wer (csrc/wer.cu) against ops/wer.greedy_wer_counts
            on the card, errors and tokens equal exactly, twice each: the
            train cell's shapes (B=64, T' 47-110, L 16-40, a sixth of the
            rows invalid, the step's transposed ids), benchmark's 512 x
            80, rows with no frames, no targets or only blanks, ids and
            targets outside the kernel's table (>= 128 and < 0), L=64 and
            65 (one word of the bit-vectors and two), and L=1023, the
            largest the wrapper takes; the distances and counts equal to
            the parent tree's kernel's where there is one (PARENT_TREE);
            then its time against the plain loop's at B=64, T'=110, L=40
            (CUDA events, in turns), a call to a synchronize, and at
            TURN_SHAPES its device time in turns with the parent's kernel
            beside its chain floor and bound, as in kernel-beam.
3c. kernel-beam  ctc_beam (csrc/ctc_beam.cu) against
            decode/beam_jit.beam_search_batch on the card: profile-evaluate's
            shape (B=64, T'=110, K=10, C=43) with and without a bigram LM
            at alpha 0.5, benchmark's 512 x 80, ragged lengths, B=1, K=1,
            K=16, K=16 with C=64 (the limits), one-hot posteriors with
            and without the LM and log-probs (and LM) on a grid of 0.5, so
            that ties decide the order: every sequence and normalised
            score equal bit for bit (the bars of at least 99% identical
            and a token error of at most 0.002 printed beside), zeros
            after every prefix, the same bits twice, and the bits of the
            parent tree's kernel where there is one (PARENT_TREE); 16 rows
            against the host beam (decode/beam.py) at BEAM_MATCH; then its
            time against the plain loop's at profile-evaluate's shape (in
            turns), and at TURN_SHAPES (B=1, 64, 512 x 80) in turns with
            the parent's kernel (parent, tree, tree, parent) beside its
            chain floor (the -DMDD_CTC_BEAM_SKELETON build: the frame
            loop, its barriers and shared-memory round trips, no
            arithmetic) and its bound, in us a frame: device times, by
            CUDA events over replays of a CUDA graph of ten calls
            (ops/frame_stamps.graph_ms, the wrappers' host work left
            out).
3d. kernel-ctc  ctc_alpha and ctc_beta_grad (csrc/ctc_loss.cu, the CTC
            loss's two recursions and its gradient) against
            ops/ctc_cuda's plain versions on the card: the train cell's
            shapes (B=64, T' 47-110, L 16-40; the step's transposed
            log-probs), benchmark's 512 x 80, input lengths 0 and 1, label
            lengths 0, a row no alignment fits, repeated (padded) rows,
            T'=1, L=0, L=511 (S=1023, the largest the wrapper takes) and
            labels repeated back to back (no skip allowed): nll within
            1e-5 relative, the alphas of each row's frames and the gradient
            within 1e-5, the same bits twice, and the gradient equal to the
            parent tree's kernel's bit for bit where there is one; then
            their times at B=64, T'=110, L=40 against the plain versions'
            and F.ctc_loss's (the yardstick: forward, and forward +
            backward, its host syncs included), in turns, the bound and us
            a frame; ctc_alpha's nll and every row's alphas equal to the
            parent tree's kernel's bit for bit where there is one; both
            kernels at TURN_SHAPES in turns with the parent's beside
            their chain floors and bounds, as in kernel-beam.
3e. kernel-scan  lstm_scan_fwd and lstm_scan_bwd (csrc/lstm_scan.cu:
            mdd_tpu/ops/lstm.py's bilstm and JAX's autodiff of it, the
            bfloat16 text BiLSTM's route) against ops/lstm_cuda's plain
            versions on the card at the text BiLSTM's shapes (T=L in {1,
            7, 48}, B in {1, 64, 512, 513}, and 48 x 1040, past one
            launch of either recurrence; D=512, H=384, bfloat16): hs, cs,
            dx_proj and dW_hh within SCAN_TOL of each tensor's largest
            magnitude, one count a call, each call's plans printed, the
            same bits twice at 48 x 513; then their times (CUDA events)
            at 48 x 512, 48 x 64 and 7 x 1 beside the plain versions',
            their bounds, the backward's launches one by one and a bf16
            torch.nn.LSTM(512, 384, bidirectional) layer as the
            yardstick (cuDNN: another contract), and their device times
            (CUDA-graph replays) in turns with the parent tree's scan
            kernels (parent, tree, tree, parent), bound by what its
            sources hold (ops/lstm_stamps.scan_bindings; no turns where
            it holds none this package can call).
3f. kernel-lstm-parent  lstm_fwd and lstm_bwd (the Pallas contract)
            against the parent tree's build of the same two sources
            (PARENT_TREE), float32 and bfloat16, T'=80 at B=64 and 512 and
            T'=16 at B=1: hs, cs, dx_proj and dW_hh equal bit for bit
            (taking the scan instances out of those files changed none of
            their bits); not run without a parent tree.
4. model    the full-width flagship model (model_config of
            checkpoints/syn_full/best.meta.json) with seeded weights made in
            the flax layout and passed through convert.flax_to_torch: one
            forward with the kernel, one with the plain LSTM, log-probs
            compared.
4a. visualize  utils/visualize.capture_activations on that model, one
            utterance of T'=80: the 6 activations of mdd_tpu's list
            (conv, rnn0's dropout and output, rnn1's BatchNorm, dropout
            and output) and the log-probs on the kernel against the plain
            LSTM within phase model's tolerance, lstm_fwd launched 5
            times (zeroed just before); then visualize_utterance writes
            its 8 PNGs, or raises the ImportError that names matplotlib
            where it is missing.
5. serve    the serving path a user runs: seeded 16 kHz wavs, their CMVN
            stats, a 41-unit inventory, the dictionary files of phase 6, a
            YAML config and a port checkpoint on disk, then `python -m
            mdd_tpu_torch serve` in-process on JSON request lines that carry
            their canonical phones, and the engine it builds on groups that
            batch 1, 4 and 16 requests.  Every response must be ok; the
            kernel's launch counter, zeroed just before, must cover all 5
            BiLSTM layers of every forward; then, not gating, the batch-1
            p50 with the text BiLSTM on the kernels against the plain
            loop, in turns.
6. lexicon  the lexicon and the product entry points on phase 5's files:
            CMUdict, IPA, phonics and ECDICT files of 8 prompt words typed
            in (a ninth word is in no dictionary), then `python -m
            mdd_tpu_torch infer` in-process over N.wav + N.txt pairs three
            ways (--decode-dump; --phonetic-format ipa --forgiving 1;
            --textgrid-path): one report per pair whose canonical row is
            the port's lexicon's phones (or the TextGrid's), the RTF lines,
            one dump line per pair; `serve --warmup --max-batch 4` on
            word-only requests (one with a canonical override): every
            response ok with its IPA, translation and phonics, no group past
            4; lstm_fwd launches, zeroed before each, covering 5 layers of
            every forward.  Then, not gating: p50 batch-1 latency of
            word-only against canonical-carrying requests in turns, the
            lexicon's host time a word, and the first lookup's load of a
            seeded dictionary pair of CMUdict 0.7b's size (135,000 entries).
7. product  the product front end and socket serving on phase 5's files:
            (a) `feat` in-process over a seeded wav.scp of 64 wavs of
            0.6-3.2 s, once a feature type (fbank, mfcc, spectrogram), on
            the card and on the CPU: features within 2e-4 plus each
            element's float32 rounding bound (feature_tol), the CMVN files
            written; `bulk_load` of the fbank ark through the native reader
            equal bit for bit to the Python pass, both timed.  (b) `infer`
            with its default --denoise over phase 6's pairs: one report a
            pair, the RTF lines, lstm_fwd launched 5 times a forward; the
            denoiser raises the SNR of a seeded noisy tone by 3 dB; its
            host ms per audio-second.  (c) `serve --socket 127.0.0.1:0
            --max-batch 16 --warmup` and `serve --socket PATH` in threads:
            4 TCP clients x 16 requests and a unix client x 8 at once,
            every answer ok and equal to its solo answer on the decoded and
            canonical rows, faults and score, no group past 16, lstm_fwd 5
            times a forward, 0.0.0.0 refused, and a client that stops
            reading dropped while another's answers come within 2 s.  (d)
            Not gating: the port's serve_loadtest for 10 s at 1, 4 and 16
            clients, denoise on and off: p50 / p90 / p99 and requests/s.
8. profile  torch.profiler over batch-1 requests: device busy share and
            the kernels that take the device time.
9. model-grad  the full-width model, one Trainer step at B=8 (dropout 0)
            with the kernels and one with the plain LSTM: loss, every
            parameter's gradient and the updated BN statistics compared.
10. train    the training path a user runs: a seeded corpus (512 train, 64
            dev utterances of 16-40 phones of the 41-unit inventory, 81-dim
            band-template features) written with the port's ArkScpWriter, a
            YAML of the flagship recipe, then `python -m mdd_tpu_torch train`
            in-process for one epoch and `--resume` for a second.  Losses
            finite and falling, `best` and `latest` on disk, the launch
            counters (zeroed just before) covering every layer of every
            step, greedy_wer and ctc_alpha once a train or validation step
            and ctc_beta_grad once a train step; then the step time at
            B=64, the step median with the WER on its kernel against the
            plain loop, in turns, and with the text BiLSTM on the kernels
            or the plain loop and the loss on the CTC kernels or
            F.ctc_loss (four ways, in turns: `model.text.lstm.rnn` and
            `train.loop.ctc_loss` swapped in the script).
10a. train-strict  `python -m mdd_tpu_torch train` as a fresh process
            (nothing of this script runs in it) for one epoch of that
            corpus: the Trainer's first line must state TF32 off for
            cuBLAS and cuDNN (the port's float32 rule; this script sets
            no flag for the whole process).  Not gating: its first step's
            loss against phase train's.
10b. resume-plateau  `train` in-process at full width on the kernels,
            dropout 0, a halving every second epoch and `latest` every
            epoch, the plateau machine fed a rising dev loss (so each
            halving restores epoch 1's state; PLATEAU_SEEN_LOSS says
            why): 6 epochs in one run against 3 and `--resume` to 6.  The
            epoch-4 restore after the resume installs the snapshot that
            `latest` held at epoch 3, bit for bit; both runs take the
            same plateau actions; then, its snapshot file deleted,
            `latest` still resumes (to epoch 7) and says it has none;
            the launch counters cover every layer of every step.
            Printed: the two runs' dev losses by epoch
            (within 1e-3, not gating), the epoch walls and each
            `latest`'s write time and bytes by file.
10c. resume-mdd_tpu  an mdd_tpu run handed to the port at full width:
            resume-plateau's `.pt` `latest` (epoch 6, dropout 0) written
            in mdd_tpu's orbax format by save_mdd_tpu_checkpoint (its
            seconds and bytes, and the `.pt` write's) and read back with
            read_orbax_checkpoint (the leaves' SHA-256 equal to the tree
            written); two fresh Trainers on the card restored from the
            `.pt` and from the orbax directory agree bit for bit (weights,
            BatchNorm statistics, Adam's moments and steps, the rate, the
            scheduler, the histories); `train --resume` in-process on the
            orbax directory for 2 epochs (and on the `.pt` for 1): the log
            names the epoch and the format, the first resumed step's loss
            within 1e-3 of the `.pt` resume's; then `latest/` and `best/`
            are orbax with no `.pt`, the meta and `latest.snap.pt` at the
            new epoch, and `latest/` read back through the Adam map equal
            to the trainer's last `latest` bit for bit; the launch
            counters cover every layer of every step.
11. profile-train  torch.profiler over 3 train steps, on the kernels and
            as before them (the text BiLSTM's plain loop, F.ctc_loss):
            device busy share, the ops that take the device time, device
            ops and host syncs a step.
12. timing  one BiLSTM layer at B=1, 16 and 64, T'=80: the forward kernel
            (and its plan), its plain version, its bound, the port's layer
            and one torch.nn.LSTM call (a whole layer, the yardstick); the
            backward at B=16, 64, 256 and 512, T'=80, its plain version,
            its launches one by one (the pre-activation product, the
            recurrence, the dW_hh product: ms and effective TFLOP/s), and
            the backward of one torch.nn.LSTM (forward+backward minus
            forward) as the yardstick only.
13. kernel-dropout  fused_dropout against its plain version, bit for bit,
            float32 and bfloat16, rates 0.1 / 0.2 / 0.5, at the 3 site
            shapes of a B=64, T=220 (T'=110) step (conv0 64x32x220x122,
            conv1 64x32x110x61, BiLSTM 110x64x768) and at sizes that are
            not multiples of 4 (1, 3, 1023, 7x129), past one wave of
            resident threads (9,000,001) and on storage one element off
            16-byte alignment; kept share within 4 sigma of keep; the
            autograd gradient = mask / keep * dy with the forward's mask;
            two seeds, two masks.
14. train-fused  the flagship model with use_fused_dropout=True through
            cli._build_loader, cli.build_trainer and Trainer.fit for 3
            epochs of the corpus (seconds; after one epoch the posteriors
            are too flat to score a beam with an LM against greedy): loss
            finite and falling, 12 dropout launches a train step (6 sites,
            forward and backward), `best` on disk with use_fused_dropout
            in its meta; then the step time and the device time of a step
            with fused and with plain dropout, in turns.
15. train-bf16  the flagship recipe with compute_dtype bfloat16 (the
            shipped recipes' dtype) and use_fused_dropout=True, through the
            entry points of phase 14 for one epoch: losses finite and
            falling, every layer of every step on the kernels (the four
            acoustic ones on lstm_fwd / lstm_bwd, the text BiLSTM on
            lstm_scan_fwd / lstm_scan_bwd), the step median; the B=64
            step median with the text BiLSTM on the scan kernels against
            the plain loop (kernels, plain, plain, kernels) and the device
            ops a step of each (torch.profiler); then 3 steps of that
            model at bench.py's cell (B=512 x 160 frames, L=48, the
            largest batch a train step gives the dropout kernel): losses
            finite, fused_dropout 12, lstm_bwd 4 and lstm_scan_fwd /
            lstm_scan_bwd 1 counts a step, the step times; then the step
            median there with the loss on the CTC kernels against
            F.ctc_loss, and with the text BiLSTM on the scan kernels
            against the plain loop (with device ops a step), in turns.
16. train-cached  the training path on the device-resident corpus: a
            hard-profile corpus (512 / 64 / 64 utterances of 16-40 phones,
            the recovered 41-unit inventory) from `python -m
            mdd_tpu_torch.tools.synthetic_corpus`, then `train` in-process
            with device_cache: true (the flagship recipe at B=64, the hard
            recipe's quanta) for 2 epochs and `--resume` for a third:
            losses finite and falling, the launch counters covering every
            layer of every step, the resumed epoch's batches those of a
            fresh loader at set_epoch(2), one CachedBatch gathered and
            masked on the card equal bit for bit to
            SpeechDataset.load_item's items padded to its bucket; then the
            cached and the streaming step median (next batch, copy and
            step), in turns, and the host -> device bytes a step of each.
17. evaluate  `train-lm` on the training labels, then `evaluate` (beam
            width 10 + that LM at alpha 0.5, device front end, the dev
            split as test split) on the `best` of phase 14 with
            --dump-dir, `evaluate --lm-alpha 0`, `evaluate --decode-type
            Greedy`, and `mdd-result` on the beam + LM dumps, all
            in-process: the reports parse, the canonical total equals the
            dump's phones, mdd-result's PER is evaluate's, lstm_fwd
            launched 5 times a forward, ctc_beam once a batch of the two
            beam passes, the three PERs close; on one
            batch of that model's log-probs the
            device beam against the host beam (decode/beam.py), at least
            95% of the sequences identical.
18. evaluate-cached  `evaluate --cached` and `evaluate` on the hard
            test split with train-cached's `best` (beam 10 + the corpus
            LM at alpha 0.5): at batch size 1, where both loaders pad an
            utterance alike, reports and dump lines equal; at B=64, where
            the cache groups utterances by bucket, every utterance padded
            alike decodes alike (the model's outputs depend on the
            padding); lstm_fwd launched 5 times a forward.
19. profile-evaluate  evaluate_model over the 512 training utterances:
            utterances per second of beam + LM on the beam kernel and on
            the plain frame loop (in turns) and of greedy, and
            torch.profiler's device busy share over one beam pass; the
            beam alone at B=64, T'=110, K=10, C=43 three ways in turns
            (decode_log on the kernel, the kernel's launch by CUDA events,
            decode_log on the plain loop: ms a batch and a frame) and the
            plain loop's device ops a frame; fused_dropout at the 3
            site shapes in float32 and bfloat16: a call (CUDA events) and
            its kernel's device time (torch.profiler) beside its bound (the
            larger of bytes and integer operations), its plain version and
            F.dropout (the yardstick only; ops/dropout_time.py).
20. distributed  `train --distributed` and `evaluate --distributed` at
            full width, each rank a subprocess of the port's CLI with
            torchrun's variables (a timeout each; a rank that fails or
            hangs fails the phase): (a) 2 ranks x 32 sharing the card
            (gloo) against 1 process x 64 for an epoch of the corpus at
            dropout 0, on the streaming loader (global schedule) and on the
            row-sharded device cache: the ranks' logged losses equal bit
            for bit, the train losses within 1e-4 of one process's, the dev
            loss within 3e-4 (DDP_DEV_RTOL says why); (b) 2 x 32 with
            dropout 0.2 through the fused kernel: per rank, lstm_fwd 5 a
            forward, lstm_bwd 5 and fused_dropout 12 a train step; (c)
            `evaluate --distributed` (beam + LM) on train-fused's `best`,
            2 ranks against one process (per rank lstm_fwd 5 a forward,
            no other launch): the same tallies at batch 1, and
            utterances/s at batch 1 and 64; (d) the step medians of 1 x 64
            and 2 x 32 and the gradient all-reduce's time a step; (e) with
            two cards or more, (a) as 2 ranks x 32 over two cards (nccl),
            with four also 4 x 16 over four; else a line that says it was
            not run.
20a. trained  the committed trained model `checkpoints/syn_full/best`,
            mdd_tpu's orbax checkpoint, read by the port's reader with no
            conversion: (a) the read timed, its 53 leaves held to the
            SHA-256 that orbax's own restore gives (SYN_FULL_SHA256); (b)
            the corpus it was trained on regenerated by `python -m
            mdd_tpu_torch.tools.synthetic_corpus` (easy profile, 5,496 /
            897 / 900, 16-40 phones, the 41 units), then `evaluate
            --checkpoint checkpoints/syn_full/best` on the test split with
            conf/synthetic_full.yaml's decode (beam 10, no LM): at least
            99% of the 900 decodes identical to mdd_tpu's own decode of
            the split (results/syn_full_best_mdd_tpu_cpu/) and PER within
            0.10 points of its; lstm_fwd launched 5 times a forward and
            ctc_beam once; then
            `evaluate --cached` (its agreement printed, not gating: the
            cache pads by bucket); utts/s of both; (c) `serve --checkpoint
            checkpoints/syn_full/best` in-process on phase 5's request
            lines: every answer ok and equal to the answers from a port
            `.pt` checkpoint that save_checkpoint wrote from the same state
            dict, lstm_fwd 5 times a forward.  Not gating: `evaluate`'s
            utts/s with the text BiLSTM on the kernels against the plain
            loop, in turns.
20b. local-cards  `train` and `evaluate` over every card of the host
            from one command, as mdd_tpu's one-process mesh
            (parallel/launch.py starts a rank a card, each as RANK_BOOT).
            One card: `train` at data_parallel 0 (the flagship recipe at
            B=64, one epoch, dropout 0) runs in this process with no
            process group (the launcher refused), lstm_fwd 5 a forward
            and lstm_bwd 5 a step; data_parallel 2 raises make_mesh's
            ValueError before any rank.  Two cards or more: that epoch
            at data_parallel 1 (one process) against 2 and 0 (every
            card; nccl, rank r on card r, B=64 shared): the ranks' losses
            alike, train within 1e-4 and dev within DDP_DEV_RTOL of one
            card's, the step medians and nccl's gradient all-reduce by
            rank, the launches on every rank; `evaluate` of
            checkpoints/syn_full/best (phase trained's split) on every
            card against phase trained's one-card run: one set of dumps,
            at least 899 of 900 decodes equal, PER within 0.10; each
            kernel on cuda:1 with cuda:0 current against its plain
            version, its barrier counters on cuda:1.  Every other phase
            runs on one card (ONE_CARD; data_parallel 1 in its YAMLs).
21. benchmark  `python -m mdd_tpu_torch benchmark` in-process at its full
            sizes (mdd_tpu_torch/bench.py, the port of bench.py): the train
            step at B=512 x 160 frames in bfloat16 (5 + 30 steps), the
            device beam at 512 x 80, K=10, fbank / MFCC on 128 x 3 s and
            `feat` over 900 wavs, `evaluate` over 900 utterances streaming
            and cached on the trained model (`eval_checkpoint` must read
            "syn_full/best"), epochs over 5,496 utterances cached and
            streaming.
            Exactly one JSON line on stdout with bench.py's metric, unit
            and every `extra` key of bench.py (read from its source) and
            the port's `card` and `peak_flops`; value > 0, 0 < mfu <= 1
            against the listed bf16 peak, 900 utterances in every
            evaluation pass; lstm_fwd 4 counts a bfloat16 train step and
            5 an evaluation forward of the float32 trained model, lstm_bwd
            4 a train step, lstm_scan_fwd and lstm_scan_bwd 1 a train step
            over the phase (every Trainer step and evaluation forward
            counted apart), fused_dropout 0 (bench.py leaves it
            off), greedy_wer at least once a step, ctc_alpha as often,
            ctc_beta_grad once a train step, ctc_beam more than once
            an evaluation forward (the decode section's rounds too); the
            B=512 backward's recurrence plan, the line, the phase's wall
            time and peak device memory logged; then, not
            gating, torch.profiler over 3 steps of the train section's
            cell: device busy share and the ops that take the time.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Exits 2 without a CUDA device, or when run
outside a checkout of the repo.

    python3 chip_smoke.py --local-cards   # a host of two cards or more

runs phase local-cards alone, after what it holds the cards to (the build,
the seeded corpus, the trained model's split and its one-card evaluate),
then `python -m mdd_tpu_torch benchmark` as a user runs it there, over
every card: rank 0's one JSON line, n_cards the card count, 0 < mfu <= 1
over their peak.  Its last line is {"local_cards": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "_smoke"
# every phase but local-cards (and distributed's own ranks) runs on one
# card: `evaluate` and `benchmark` take every visible card unless their
# --device names one, `train` the YAML's data_parallel (1 here)
ONE_CARD = "cuda:0"
SEED = 0
H = 384
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # kernel vs plain, hs and cs:
# float32 differs in the summation order of the recurrent dot and in its
# three TF32 passes (~2^-20 of a product); bfloat16 rounds h every step, so
# a 1-ulp rounding (2^-8) can carry on
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # kernel vs plain, dx_proj
# and dW_hh, each relative to its largest magnitude: float32 sums run in
# another order (dh as partial sums of up to H/8 blocks, dW over all T*B
# rows at once instead of step by step) and every float32 product is three
# TF32 passes on the tensor cores (~2^-20 of a product); bfloat16 rounds
# dgates, so a 1-ulp rounding (2^-8) can carry into the earlier steps
MODEL_TOL = 1e-4   # full-model log-probs, float32, kernel vs plain LSTM
GRAD_TOL = 1e-3    # full-model gradients, float32, kernels vs plain LSTM,
# each relative to its tensor's largest magnitude: the sums of both kernels
# run in another order and the differences pass through 4 layers of
# train-mode BatchNorm and the recurrences
ZERO_ULPS = 64     # a tensor whose plain gradient stays within this many
# float32 ulps of the largest gradient is 0 up to rounding (a bias that
# feeds a train-mode BatchNorm, which subtracts the batch mean): its
# relative error is noise, so both runs' gradients are held below that
TRAIN_UTTS, DEV_UTTS, BATCH = 512, 64, 64
# (B, T') the recurrence takes in phase benchmark: the train section's step,
# the epoch's and the cached evaluation's batch, the streaming evaluation's
BENCH_SHAPES = [(512, 80), (256, 80), (128, 112)]
FUSED_EPOCHS = 3
PER_GAP = 5.0      # beam (with and without the LM) vs greedy PER, percentage
# points: the LM trained on the corpus's near-uniform phone strings acts as
# an insertion penalty of ~1.8 nats a phone at alpha 0.5, which a model of
# 3 epochs mostly outweighs
BEAM_MATCH = 0.95  # device beam vs host beam, share of identical sequences
# (float32 against float64 scores can reorder near-tied prefixes)
# H100 SXM published peaks (NVIDIA data sheet), dense, at 700 W; the FLOP/s
# by dtype are mdd_tpu_torch.bench's table, which main() reads
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS: dict = {}
# the 41-unit inventory that regenerates mdd_tpu's hard-profile test split
HARD_UNITS = ROOT / "results" / "synthetic_full_hard_torch" / "units"
UNITS = ["sil", "err", "aa", "ae", "ah", "ao", "aw", "ay", "b", "ch", "d",
         "dh", "eh", "er", "ey", "f", "g", "hh", "ih", "iy", "jh", "k", "l",
         "m", "n", "ng", "ow", "oy", "p", "r", "s", "sh", "t", "th", "uh",
         "uw", "v", "w", "y", "z", "zh"]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def bound(nbytes: float, flops: float, dtype: str) -> tuple:
    """(least ms, what bounds it) for moving nbytes and doing flops."""
    by_bytes = nbytes / PEAK_BYTES_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes > by_ops
                                   else "operations")


def lstm_bwd_bound_ms(t: int, b: int, h: int, dtype: str) -> tuple:
    """Least time for the backward on these inputs: x_proj, hs, cs and dhs
    (float32) read once, dx_proj written once, w_hh read and dW_hh (float32)
    written once; three times the forward's dots (gate recompute, dh_{t-1},
    dW_hh) plus ~20 operations of gate math per hidden unit and step."""
    elt = 4 if dtype == "float32" else 2
    seq = t * 2 * b
    nbytes = (elt * (seq * 4 * h * 2 + seq * h * 2 + 2 * h * 4 * h)
              + 4 * (seq * h + 2 * h * 4 * h))
    flops = 3 * 2 * seq * h * 4 * h + 20 * seq * h
    return bound(nbytes, flops, dtype)


def lstm_bound_ms(t: int, b: int, h: int, dtype: str) -> tuple:
    """Least time for the recurrence on these inputs: x_proj and w_hh read
    once, hs and cs written once; the recurrent dots plus the gate adds."""
    elt = 4 if dtype == "float32" else 2
    nbytes = elt * (t * 2 * b * 4 * h + 2 * h * 4 * h + 2 * t * 2 * b * h)
    flops = 2 * t * 2 * b * h * 4 * h + t * 2 * b * 4 * h + 4 * t * 2 * b * h
    return bound(nbytes, flops, dtype)


def phase_build() -> None:
    from mdd_tpu_torch.ops import build, frame_stamps, lstm_stamps

    t0 = time.time()
    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    # and the variants phases kernel-wer, -beam and -ctc time: the chain
    # floors' skeleton builds, the parent tree's kernels
    parent = parent_tree()
    variants = []
    for name, (source, _, prefix, _) in frame_stamps.KERNELS.items():
        variants.append((source, (f"-D{prefix}_SKELETON",)))
        if parent:
            variants.append((frame_stamps.parent_source(name, parent), ()))
    if parent:     # phase kernel-lstm-parent's, and kernel-scan's turns
        variants += [(str(parent / "mdd_tpu_torch" / "csrc" / s), ())
                     for s in ("lstm_fwd.cu", "lstm_bwd.cu")]
        variants += [(k.source, ())
                     for k in lstm_stamps.scan_bindings(parent) or ()]
    # all at once; a parent source equal to the tree's builds to the same
    # library, which one compile makes
    procs, paths = [], set()
    for s, f in [(s, ()) for s in sources] + variants:
        if build.library_path(s, f) not in paths:
            paths.add(build.library_path(s, f))
            procs.append((s, f, build.start_build(s, f)))
    hosts = [(t, build.start_host_build(t)) for t in build.HOST_TARGETS]
    for target, proc in hosts:
        log(f"  g++ {target}: {build.finish_host_build(target, proc).name}")
    for source, flags, proc in procs:
        out = build.finish_build(source, proc, flags)
        for line in out.splitlines() if not flags else []:
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  ptxas {source}: {line.strip()}")
    log(f"[build] {len(sources)} source(s) {sources} and host targets "
        f"{list(build.HOST_TARGETS)}, {len(variants)} variant(s) "
        f"{[(Path(s).name, f) for s, f in variants]} in "
        f"{time.time() - t0:.2f} s; parent tree {parent}")


def phase_kernel(torch) -> dict:
    from mdd_tpu_torch.ops.lstm_cuda import (
        lstm_fwd_kernel,
        lstm_seq_fwd_reference,
    )
    from mdd_tpu_torch.utils.precision import strict_float32

    strict_float32("cuda", "float32")     # the plain version's products
    g = torch.Generator().manual_seed(SEED)
    worst = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        worst[dtype] = 0.0
        # the serving and training shapes, then a batch the kernel splits
        # over two unit groups a block and two that take several launches
        cases = [(b, t) for b in (1, 4, 16, 64) for t in (16, 80, 128)]
        for b, t in cases + [(24, 16), (256, 16), (512, 4)] + BENCH_SHAPES:
            x_proj = (torch.randn((t, 2, b, 4 * H), generator=g) * 0.5
                      ).to("cuda", dt)
            w_hh = ((torch.rand((2, H, 4 * H), generator=g) * 2 - 1)
                    / H ** 0.5).to("cuda", dt)
            hs, cs = lstm_fwd_kernel(x_proj, w_hh)
            torch.cuda.synchronize()
            ref_hs, ref_cs = lstm_seq_fwd_reference(x_proj, w_hh)
            err = max((hs.float() - ref_hs.float()).abs().max().item(),
                      (cs.float() - ref_cs.float()).abs().max().item())
            log(f"  lstm_fwd {dtype} B={b} T'={t}: max |hs, cs - plain| "
                f"= {err:.3e}")
            if not err <= TOL[dtype]:
                raise AssertionError(
                    f"lstm_fwd {dtype} B={b} T'={t} differs from its "
                    f"plain version by {err} > {TOL[dtype]}")
            worst[dtype] = max(worst[dtype], err)
    log(f"[kernel] lstm_fwd matches lstm_seq_fwd_reference: float32 max err "
        f"{worst['float32']:.3e} (tol {TOL['float32']}), bfloat16 "
        f"{worst['bfloat16']:.3e} (tol {TOL['bfloat16']})")
    return worst


def phase_kernel_bwd(torch) -> dict:
    """lstm_bwd against lstm_seq_bwd_reference at the training shapes, on
    saved (hs, cs) of the plain forward and a random cotangent."""
    from mdd_tpu_torch.ops.lstm_cuda import (
        lstm_bwd_kernel,
        lstm_seq_bwd_reference,
        lstm_seq_fwd_reference,
    )
    from mdd_tpu_torch.utils.precision import strict_float32

    strict_float32("cuda", "float32")

    g = torch.Generator().manual_seed(SEED + 1)
    worst = {}
    # the training shapes, then batches whose recurrence runs as several
    # launches (300: a ragged last one; 512: bench.py's batch), then the
    # benchmark's own
    cases = [(b, t) for b in (1, 4, 16, 24, 64) for t in (16, 80, 128)]
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        worst[dtype] = 0.0
        for b, t in cases + [(256, 16), (300, 8), (512, 8)] + BENCH_SHAPES:
            x_proj = (torch.randn((t, 2, b, 4 * H), generator=g) * 0.5
                      ).to("cuda", dt)
            w_hh = ((torch.rand((2, H, 4 * H), generator=g) * 2 - 1)
                    / H ** 0.5).to("cuda", dt)
            dhs = torch.randn((t, 2, b, H), generator=g).cuda()
            hs, cs = lstm_seq_fwd_reference(x_proj, w_hh)
            before = lstm_bwd_kernel.launches
            dxp, dw = lstm_bwd_kernel(x_proj, w_hh, hs, cs, dhs)
            torch.cuda.synchronize()
            if lstm_bwd_kernel.launches != before + 1:
                raise AssertionError("lstm_bwd did not count its launch")
            plan = lstm_bwd_kernel.plan(t, b, H, dt)
            if b >= 256:
                again = lstm_bwd_kernel(x_proj, w_hh, hs, cs, dhs)
                if not (torch.equal(dxp, again[0])
                        and torch.equal(dw, again[1])):
                    raise AssertionError(f"lstm_bwd B={b} changed its bits "
                                         "from one run to the next")
            ref_dxp, ref_dw = lstm_seq_bwd_reference(x_proj, w_hh, hs, cs,
                                                     dhs)
            errs = [rel_err(dxp, ref_dxp), rel_err(dw, ref_dw)]
            abs_err = max((dxp.float() - ref_dxp.float()).abs().max(),
                          (dw - ref_dw).abs().max()).item()
            log(f"  lstm_bwd {dtype} B={b} T'={t}: max |dx_proj - plain| "
                f"/ max |plain| = {errs[0]:.3e}, dW_hh {errs[1]:.3e}; "
                f"max abs err {abs_err:.3e}; {plan['launches']} recurrence "
                f"launch(es) of {plan['chunk_rows']} rows")
            if not max(errs) <= BWD_TOL[dtype]:
                raise AssertionError(
                    f"lstm_bwd {dtype} B={b} T'={t} differs from its "
                    f"plain version by {max(errs)} > {BWD_TOL[dtype]}")
            worst[dtype] = max(worst[dtype], *errs)
            worst[dtype + "_abs"] = max(worst.get(dtype + "_abs", 0.0),
                                        abs_err)
    log(f"[kernel-bwd] lstm_bwd matches lstm_seq_bwd_reference: float32 max "
        f"rel err {worst['float32']:.3e} (tol {BWD_TOL['float32']}), "
        f"bfloat16 {worst['bfloat16']:.3e} (tol {BWD_TOL['bfloat16']})")
    return worst


def phase_kernel_staging(torch) -> None:
    """Both LSTM kernels launched over and over at B=1, T'=16 while a
    thread stages small host arrays on the card (what evaluate's staging
    thread does between two forwards): the same bits every launch, and
    nothing written into the thread's tensors.  The thread's arrays have
    the barrier counters' size, so that they take the blocks the wrappers
    free."""
    import numpy as np

    from mdd_tpu_torch.ops.lstm_cuda import lstm_bwd_kernel, lstm_fwd_kernel
    from mdd_tpu_torch.utils.precision import strict_float32

    strict_float32("cuda", "float32")
    g = torch.Generator().manual_seed(SEED + 4)
    t, b, launches = 16, 1, 200
    x_proj = (torch.randn((t, 2, b, 4 * H), generator=g) * 0.5).cuda()
    w_hh = ((torch.rand((2, H, 4 * H), generator=g) * 2 - 1) / H ** 0.5
            ).cuda()
    dhs = torch.randn((t, 2, b, H), generator=g).cuda()
    hs, cs = lstm_fwd_kernel(x_proj, w_hh)
    runs = {"lstm_fwd": lambda: lstm_fwd_kernel(x_proj, w_hh),
            "lstm_bwd": lambda: lstm_bwd_kernel(x_proj, w_hh, hs, cs, dhs)}
    host = np.arange(2 * 32, dtype=np.int32)
    for name, run in runs.items():
        first = run()
        stop, staged = threading.Event(), []

        def stage():
            while not stop.is_set():
                staged.append(torch.as_tensor(host).to("cuda",
                                                       non_blocking=True))

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        thread = threading.Thread(target=stage)
        thread.start()
        try:
            outs = [run() for _ in range(launches)]
        finally:
            stop.set()
            thread.join()
            sys.setswitchinterval(interval)
        differ = sum(not (torch.equal(o[0], first[0])
                          and torch.equal(o[1], first[1])) for o in outs)
        want = torch.as_tensor(host, device="cuda")
        written = int((torch.stack(staged) != want).any(dim=1).sum())
        log(f"[kernel-staging] {name} B={b} T'={t}: {launches} launches "
            f"beside a staging thread's {len(staged)} copies: {differ} "
            f"launches off the first's bits, {written} of the thread's "
            "tensors written to")
        if differ or written:
            raise AssertionError(f"{name} and a staging thread disturb "
                                 f"each other: {differ} launches differ, "
                                 f"{written} staged tensors changed")


# ---------------------------------------------------------------------------
# the two device programs of mdd_tpu ported as kernels: the train WER's
# collapse + edit distance (csrc/wer.cu) and the CTC prefix beam
# (csrc/ctc_beam.cu); each launch on a path is counted by path

#: path -> launches of greedy_wer / ctc_beam / ctc_alpha / ctc_beta_grad /
#: lstm_scan_fwd / lstm_scan_bwd on it (zeroed just before the path runs,
#: read just after; launches that compare a kernel with its plain version
#: are not counted)
PATH_LAUNCHES = {"greedy_wer": {}, "ctc_beam": {}, "ctc_alpha": {},
                 "ctc_beta_grad": {}, "lstm_scan_fwd": {},
                 "lstm_scan_bwd": {}}
#: the flagship model's acoustic BiLSTM layers
FLAGSHIP_LAYERS = 4


def lstm_per_pass(compute_dtype: str = "float32") -> int:
    """lstm_fwd launches a forward (and lstm_bwd launches a train step) of
    the flagship model with use_pallas_lstm: one an acoustic BiLSTM, and
    in float32 one for the text BiLSTM (models/ctc_model.TextEncoder puts
    it on the scan kernels in bfloat16: lstm_scan_fwd and lstm_scan_bwd
    once a forward and a train step)."""
    return FLAGSHIP_LAYERS + (compute_dtype == "float32")


#: phase kernel-wer: (name, B, T', L, seed, case); T' 47-110 and L 16-40
#: are the train cell's, 512 x 80 benchmark's
WER_CASES = [("train T'=110 L=40", 64, 110, 40, 0, "random"),
             ("train T'=47 L=16", 64, 47, 16, 1, "random"),
             ("train T'=80 L=40, the step's transposed ids", 64, 80, 40, 2,
              "strided"),
             ("benchmark 512 x 80", 512, 80, 40, 3, "random"),
             ("pred_len 0 (no frames)", 16, 60, 24, 4, "no-frames"),
             ("target_sizes 0", 16, 60, 24, 5, "no-targets"),
             ("all-blank rows", 16, 60, 24, 6, "all-blank"),
             ("ids and targets outside the kernel's table", 64, 110, 40, 8,
              "wide-ids"),
             ("L=64, one word of the bit-vectors", 16, 110, 64, 9, "random"),
             ("L=65, two words", 16, 110, 65, 10, "random"),
             ("the largest L the wrapper takes", 8, 300, 1023, 7, "random")]
#: phase kernel-beam: (name, B, T', C, K, seed, LM, case)
BEAM_CASES = [("profile-evaluate", 64, 110, 43, 10, 0, False, "random"),
              ("profile-evaluate + LM", 64, 110, 43, 10, 1, True, "random"),
              ("benchmark 512 x 80", 512, 80, 43, 10, 2, False, "random"),
              ("ragged lengths", 64, 110, 43, 10, 3, True, "ragged"),
              ("B=1", 1, 110, 43, 10, 4, False, "random"),
              ("K=1", 64, 110, 43, 1, 5, False, "random"),
              ("K=16", 64, 110, 43, 16, 6, True, "random"),
              ("K=16 C=64", 16, 80, 64, 16, 7, True, "random"),
              ("one-hot (peaky) posteriors", 64, 110, 43, 10, 8, False,
               "peaky"),
              ("one-hot (peaky) + LM", 64, 110, 43, 10, 9, True, "peaky"),
              ("log-probs on a grid of 0.5 (ties decide the order)", 64,
               110, 43, 10, 10, False, "ties"),
              ("log-probs and LM on a grid of 0.5", 64, 110, 43, 10, 11,
               True, "ties")]
BEAM_IDENTICAL = 0.99   # kernel vs plain, share of identical sequences
BEAM_TOKEN_ERR = 0.002  # kernel vs plain, edits over the plain's tokens
HOST_ROWS = 16          # kernel vs the host beam (decode/beam.py, Python)
#: phases kernel-wer, -beam and -ctc: (B, T') at which a kernel is timed
#: in turns with the parent tree's (serving, the main path's batch,
#: benchmark's 512 x 80)
TURN_SHAPES = [(1, 110), (BATCH, 110), (512, 80)]
#: the parent commit's `mdd_tpu_torch/csrc/` for those turns (gitignored):
#: `git archive <parent> mdd_tpu_torch/csrc | tar -x -C _scratch/old`
PARENT_TREE = ROOT / "_scratch" / "old"


def parent_tree() -> Path | None:
    """PARENT_TREE where it holds the kernels; else, in a git checkout,
    HEAD~1's `mdd_tpu_torch/csrc/` unpacked there; else None (the turns
    against the parent's kernels are then left out)."""
    if (PARENT_TREE / "mdd_tpu_torch" / "csrc" / "ctc_beam.cu").exists():
        return PARENT_TREE
    if not (ROOT / ".git").exists():
        return None
    try:
        tar = subprocess.run(["git", "-C", str(ROOT), "archive", "HEAD~1",
                              "mdd_tpu_torch/csrc"], capture_output=True,
                             check=True, timeout=60).stdout
        PARENT_TREE.mkdir(parents=True, exist_ok=True)
        subprocess.run(["tar", "-x", "-C", str(PARENT_TREE)], input=tar,
                       check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return PARENT_TREE if (PARENT_TREE / "mdd_tpu_torch" / "csrc" /
                           "ctc_beam.cu").exists() else None


def frame_turns(name: str, parent, card: str) -> dict:
    """frame_stamps' kernel `name` (a key of its KERNELS) at TURN_SHAPES:
    device times (CUDA-graph replays) in turns with the parent tree's
    kernel (parent, tree, tree, parent) where there is one, its chain floor
    (the skeleton build) and its bound; -> "B=b T'=t" -> those numbers."""
    from mdd_tpu_torch.ops import frame_stamps

    out = {}
    for b, t in TURN_SHAPES:
        got = frame_stamps.time_kernel(name, None, parent and str(parent),
                                       b, t)
        if got["parent_ms"]:
            got["faster_than_parent"] = max(got["ms"]) < min(
                got["parent_ms"])
        out[f"B={b} T'={t}"] = got
    log(f"[frame-turns] {name}: "
        + "; ".join(f"{k} {min(v['ms']):.4f} ms, {v['us_per_frame']:.3f} us "
                    f"a frame, floor {v['chain_floor_ms']:.4f}, bound "
                    f"{v['bound_ms']:.6f}"
                    + (f", parent {min(v['parent_ms']):.4f} ms, faster "
                       f"{v['faster_than_parent']}" if v["parent_ms"]
                       else ", no parent tree") for k, v in out.items())
        + f" ({card})")
    return out


def new_kernels() -> dict:
    from mdd_tpu_torch.ops.beam_cuda import ctc_beam_kernel
    from mdd_tpu_torch.ops.ctc_cuda import (ctc_alpha_kernel,
                                            ctc_beta_grad_kernel)
    from mdd_tpu_torch.ops.lstm_cuda import (lstm_scan_bwd_kernel,
                                             lstm_scan_fwd_kernel)
    from mdd_tpu_torch.ops.wer_cuda import greedy_wer_kernel

    return {"greedy_wer": greedy_wer_kernel, "ctc_beam": ctc_beam_kernel,
            "ctc_alpha": ctc_alpha_kernel,
            "ctc_beta_grad": ctc_beta_grad_kernel,
            "lstm_scan_fwd": lstm_scan_fwd_kernel,
            "lstm_scan_bwd": lstm_scan_bwd_kernel}


def zero_path_launches() -> None:
    for k in new_kernels().values():
        k.launches = 0


def record_path_launches(path: str) -> dict:
    """The launches of new_kernels() since zero_path_launches, kept under
    `path`; -> them."""
    got = {n: k.launches for n, k in new_kernels().items()}
    for n, v in got.items():
        PATH_LAUNCHES[n][path] = PATH_LAUNCHES[n].get(path, 0) + v
    return got


def host_ms(fn, iters: int) -> float:
    """Mean wall ms of fn() to a synchronize, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def wer_inputs(torch, b: int, t: int, l: int, seed: int, case: str):
    """Seeded greedy-WER inputs on the card: argmax-like ids over 43
    classes (a third blank), frames in [1, t], targets of 1-42, sizes in
    [0, l], a sixth of the rows invalid; "wide-ids" moves the odd classes
    to 1000 times their id and class 4 to -4 in ids and targets alike
    (outside the kernel's table of ids [0, 128))."""
    g = torch.Generator().manual_seed(SEED + 100 + seed)
    ids = torch.randint(0, 43, (b, t), generator=g)
    ids[torch.rand((b, t), generator=g) < 0.33] = 0
    repeat = torch.rand((b, t - 1), generator=g) < 0.3
    ids[:, 1:] = torch.where(repeat, ids[:, :-1], ids[:, 1:])
    frames = torch.randint(1, t + 1, (b,), generator=g)
    targets = torch.randint(1, 43, (b, l), generator=g)
    sizes = torch.randint(0, l + 1, (b,), generator=g)
    valid = torch.rand(b, generator=g) > 1 / 6
    if case == "no-frames":
        frames[: b // 2] = 0
    if case == "no-targets":
        sizes[: b // 2] = 0
    if case == "all-blank":
        ids[: b // 2] = 0
    if case == "wide-ids":
        ids, targets = (torch.where(x == 4, -4, torch.where(x % 2 == 1,
                                                           x * 1000, x))
                        for x in (ids, targets))
    ids = ids.cuda()
    if case == "strided":       # the train step's argmax(-1).transpose(0, 1)
        ids = ids.t().contiguous().t()
    return ids, frames.cuda(), targets.cuda(), sizes.cuda(), valid.cuda()


def phase_kernel_wer(torch, card: str) -> dict:
    """greedy_wer against ops/wer.greedy_wer_counts on the card, exactly,
    and against the parent tree's kernel (distances and counts) where
    there is one; its time against the plain loop's at B=64, T'=110,
    L=40, and its device time at TURN_SHAPES in turns with the parent's."""
    from mdd_tpu_torch.ops import frame_stamps, wer_cuda
    from mdd_tpu_torch.ops.wer import greedy_wer_counts

    kernel = wer_cuda.greedy_wer_kernel
    parent = parent_tree()
    parent_kernel = parent and frame_stamps.binding(
        "wer", frame_stamps.parent_source("wer", parent))
    for name, b, t, l, seed, case in WER_CASES:
        args = wer_inputs(torch, b, t, l, seed, case)
        before = kernel.launches
        dist, counts = kernel(*args)
        dist2, again = kernel(*args)
        torch.cuda.synchronize()
        want = [int(v) for v in greedy_wer_counts(*args)]
        got = [int(v) for v in counts]
        same_parent = parent_kernel is None or all(
            torch.equal(x, y) for x, y in zip((dist, counts),
                                              parent_kernel(*args)))
        log(f"[kernel-wer] {name} (B={b}, T'={t}, L={l}): errors, tokens "
            f"{got} kernel, {want} plain; " + (
                "no parent tree" if parent_kernel is None else
                f"distances and counts = the parent's kernel's: "
                f"{same_parent}"))
        if got != want or not torch.equal(counts, again) \
                or not torch.equal(dist, dist2) or not same_parent \
                or kernel.launches != before + 2:
            raise AssertionError(f"greedy_wer {name}: kernel {got} (again "
                                 f"{again.tolist()}), plain {want}, the "
                                 f"parent's bits {same_parent}")
    b, t, l = BATCH, 110, 40
    args = wer_inputs(torch, b, t, l, 0, "random")
    kern = lambda: wer_cuda.greedy_wer(*args)
    plain = lambda: greedy_wer_counts(*args)
    times = {"kernel": [], "plain": []}
    for which, fn in (("kernel", kern), ("plain", plain), ("plain", plain),
                      ("kernel", kern)):
        times[which].append(cuda_ms(fn, 200 if which == "kernel" else 10))
    host = host_ms(kern, 200)
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    least, by = wer_cuda.bound_ms(*args[:4])
    log(f"[kernel-wer] B={b} T'={t} L={l}: kernel {times['kernel']} ms, "
        f"plain {times['plain']} ms (CUDA events, in turns), the kernel's "
        f"call {host:.4f} ms to a synchronize; bound {least:.6f} ms "
        f"({by}); {ms / t * 1e3:.3f} us a frame ({card})")
    turns = frame_turns("wer", parent, card)
    main = turns[f"B={b} T'={t}"]
    return {"max_abs_err": 0, "shape": f"B={b} T'={t} L={l} int64",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": least,
            "bound_by": by, "library_ms": None, "ms_per_frame": ms / t,
            "call_ms": host, "device_ms": min(main["ms"]),
            "chain_floor_ms": main["chain_floor_ms"],
            "parent_ms": main["parent_ms"] and min(main["parent_ms"]),
            "turns": turns}


#: phase kernel-ctc: (name, B, T', L, seed, case); T' 47-110 and L 16-40
#: are the train cell's, 512 x 80 benchmark's
CTC_CASES = [("train T'=110 L=40", 64, 110, 40, 0, "random"),
             ("train T'=47 L=16", 64, 47, 16, 1, "random"),
             ("train T'=110 L=40, the step's transposed log-probs", 64, 110,
              40, 2, "strided"),
             ("benchmark 512 x 80", 512, 80, 40, 3, "random"),
             ("input lengths 0 and 1, label lengths 0, a row no alignment "
              "fits", 64, 110, 40, 4, "edges"),
             ("padded (repeated) rows", 16, 60, 24, 5, "padded"),
             ("T'=1, L=1", 1, 1, 1, 6, "random"),
             ("no labels (L=0)", 3, 9, 0, 7, "random"),
             ("the largest L the wrapper takes (S=1023)", 4, 1100, 511, 8,
              "random"),
             ("labels repeated back to back (no skip allowed)", 64, 110, 40,
              9, "repeats")]
CTC_NLL_RTOL = 1e-5    # kernel vs plain: both take the same float steps in
CTC_GRAD_ATOL = 1e-5   # the same order; the plain class sums use atomics


def ctc_inputs(torch, b: int, t: int, l: int, seed: int, case: str,
               c: int = 43):
    """Seeded CTC inputs on the card: log-softmax of N(0, 4) logits over 43
    classes, labels 1-42 with a sixth repeated, label lengths 16..l (the
    train cell's 16-40), input lengths t/2..t; "edges" adds rows of input
    length 0 and 1, label length 0 and one no alignment fits, "strided"
    lays the log-probs out as the model's log_softmax(...).transpose(0, 1),
    "padded" repeats a row as pad_batch_to does, "repeats" makes every
    second label its predecessor (the skip between them forbidden)."""
    g = torch.Generator().manual_seed(SEED + 200 + seed)
    lp = torch.log_softmax(torch.randn((t, b, c), generator=g) * 2, -1)
    labels = torch.randint(1, c, (b, max(l, 1)), generator=g)[:, :l]
    if l > 1:
        repeat = torch.rand((b, l - 1), generator=g) < 1 / 6
        labels[:, 1:] = torch.where(repeat, labels[:, :-1], labels[:, 1:])
    label_lengths = torch.randint(min(16, l), l + 1, (b,), generator=g)
    input_lengths = torch.randint(max(1, t // 2), t + 1, (b,), generator=g)
    if case == "edges":
        input_lengths[:4] = torch.tensor([0, 0, 1, 1])
        label_lengths[:6] = torch.tensor([0, 1, 0, 1, 0, l])
        input_lengths[6] = label_lengths[6] // 2        # cannot fit
    if case == "padded":
        for x in (lp.transpose(0, 1), labels, label_lengths, input_lengths):
            x[b // 2:] = x[b // 2 - 1]
    if case == "repeats":
        labels[:, 1::2] = labels[:, 0::2][:, :l // 2]
    lp = lp.cuda()
    if case == "strided":
        lp = lp.transpose(0, 1).contiguous().transpose(0, 1)
    return lp, input_lengths.cuda(), labels.cuda(), label_lengths.cuda()


def library_ctc_loss(log_probs, input_lengths, labels, label_lengths,
                     blank: int = 0):
    """The library loss the port called before its CTC kernels, the
    yardstick only: F.ctc_loss(reduction="none", zero_infinity=True) plus a
    detached 1e30 on the rows no alignment fits (fewer frames than labels
    plus repeats), whose backward is the gradient at the logits of a
    log_softmax (exp(log_probs) - posterior).  Its tensor-length overload
    copies both length vectors to the host in the forward and again in
    the backward."""
    import torch
    import torch.nn.functional as F

    input_lengths, label_lengths = input_lengths.long(), label_lengths.long()
    labels = labels.long()
    nll = F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                     blank=blank, reduction="none", zero_infinity=True)
    pos = torch.arange(1, labels.shape[1], device=labels.device)
    repeats = ((labels[:, 1:] == labels[:, :-1])
               & (pos[None] < label_lengths[:, None])).sum(1)
    bad = input_lengths < label_lengths + repeats
    return nll + 1e30 * bad.to(nll.dtype)


def phase_kernel_ctc(torch, card: str) -> dict:
    """ctc_alpha and ctc_beta_grad against their plain versions on the card
    (nll within CTC_NLL_RTOL relative, the alphas of each row's frames and
    the gradient within CTC_GRAD_ATOL, the same bits twice); their times at
    B=64, T'=110, L=40 against the plain versions' and F.ctc_loss's, in
    turns.  -> the two `kernels` entries' numbers."""
    from mdd_tpu_torch.ops import ctc_cuda, frame_stamps

    alpha_k, grad_k = ctc_cuda.ctc_alpha_kernel, ctc_cuda.ctc_beta_grad_kernel
    parent = parent_tree()
    parent_grad = parent and frame_stamps.binding(
        "beta_grad", frame_stamps.parent_source("beta_grad", parent))
    parent_alpha = parent and frame_stamps.binding(
        "alpha", frame_stamps.parent_source("alpha", parent))
    worst = {"nll": 0.0, "nll_rel": 0.0, "grad": 0.0}
    for name, b, t, l, seed, case in CTC_CASES:
        args = ctc_inputs(torch, b, t, l, seed, case)
        g = torch.rand(b, generator=torch.Generator().manual_seed(seed)
                       ).cuda() + 0.5
        before = (alpha_k.launches, grad_k.launches)
        nll, alphas = ctc_cuda.ctc_loss_fwd(*args)
        grad = ctc_cuda.ctc_loss_bwd(*args, alphas, nll, g)
        nll2, alphas2 = ctc_cuda.ctc_loss_fwd(*args)
        grad2 = ctc_cuda.ctc_loss_bwd(*args, alphas2, nll2, g)
        torch.cuda.synchronize()
        ref_nll, ref_alphas = ctc_cuda.ctc_loss_fwd_reference(*args)
        ref_grad = ctc_cuda.ctc_loss_bwd_reference(*args, ref_alphas,
                                                   ref_nll, g)
        frames = torch.arange(t, device="cuda")[:, None] < args[1][None]
        nll_abs = (nll - ref_nll).abs()
        nll_rel = (nll_abs / ref_nll.abs().clamp_min(1e-30)).max().item()
        alpha_err = ((alphas[frames] - ref_alphas[frames]).abs()
                     / ref_alphas[frames].abs().clamp_min(1.0)).max().item() \
            if frames.any() else 0.0
        grad_err = (grad - ref_grad).abs().max().item()
        feasible = ref_nll < 5e29
        worst["nll"] = max(worst["nll"], nll_abs[feasible].max().item()
                           if feasible.any() else 0.0)
        worst["nll_rel"] = max(worst["nll_rel"], nll_rel)
        worst["grad"] = max(worst["grad"], grad_err)
        same_parent = parent_grad is None or torch.equal(
            grad, parent_grad(*args, alphas, nll, g))
        same_alpha = True
        if parent_alpha is not None:
            # the frames each kernel writes: t < max(input length, 1)
            old_nll, old_alphas = parent_alpha(*args)
            written = torch.arange(t, device="cuda")[:, None] < \
                args[1].clamp(1, t)[None]
            same_alpha = torch.equal(nll, old_nll) and torch.equal(
                alphas[written], old_alphas[written])
        log(f"[kernel-ctc] {name} (B={b}, T'={t}, L={l}): nll rel err "
            f"{nll_rel:.2e}, alphas {alpha_err:.2e}, dlog_probs abs err "
            f"{grad_err:.2e}; {int((~feasible).sum())} row(s) no alignment "
            f"fits; " + ("no parent tree" if parent_grad is None else
                         f"dlog_probs = the parent's kernel's bit for bit: "
                         f"{same_parent}, nll and alphas: {same_alpha}"))
        if not (same_parent and same_alpha):
            raise AssertionError(f"ctc kernels {name}: not the parent "
                                 f"kernels' bits (gradient {same_parent}, "
                                 f"alphas {same_alpha})")
        if not (nll_rel <= CTC_NLL_RTOL and alpha_err <= CTC_NLL_RTOL
                and grad_err <= CTC_GRAD_ATOL
                and torch.isfinite(grad).all()):
            raise AssertionError(f"ctc kernels {name}: nll {nll_rel}, alphas "
                                 f"{alpha_err}, grad {grad_err}")
        if not (torch.equal(nll, nll2) and torch.equal(grad, grad2)):
            raise AssertionError(f"ctc kernels {name}: two calls differ")
        if (alpha_k.launches, grad_k.launches) != (before[0] + 2,
                                                   before[1] + 2):
            raise AssertionError(f"ctc kernels {name}: launches "
                                 f"{alpha_k.launches - before[0]}, "
                                 f"{grad_k.launches - before[1]}, not 2")
    b, t, l = BATCH, 110, 40
    args = ctc_inputs(torch, b, t, l, 0, "random")
    g = torch.ones(b, device="cuda")
    nll, alphas = ctc_cuda.ctc_loss_fwd(*args)
    lp_grad = args[0].clone().requires_grad_(True)

    def lib_fwd():
        return library_ctc_loss(args[0], *args[1:])

    def lib_fwd_bwd():
        library_ctc_loss(lp_grad, *args[1:]).sum().backward()

    def ours_fwd_bwd():
        ctc_cuda.CtcLoss.apply(lp_grad, *args[1:], 0).sum().backward()

    fns = {"ctc_alpha": lambda: alpha_k(*args),
           "ctc_beta_grad": lambda: grad_k(*args, alphas, nll, g),
           "plain fwd": lambda: ctc_cuda.ctc_loss_fwd_reference(*args),
           "plain bwd": lambda: ctc_cuda.ctc_loss_bwd_reference(
               *args, alphas, nll, g),
           "F.ctc_loss fwd": lib_fwd, "F.ctc_loss fwd+bwd": lib_fwd_bwd,
           "ours fwd+bwd": ours_fwd_bwd}
    iters = {"plain fwd": 5, "plain bwd": 5}
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(cuda_ms(fns[k], iters.get(k, 100)))
    calls = {k: host_ms(fns[k], iters.get(k, 100))
             for k in ("ctc_alpha", "F.ctc_loss fwd", "ours fwd+bwd",
                       "F.ctc_loss fwd+bwd")}
    best = {k: min(v) for k, v in times.items()}
    lib_bwd = best["F.ctc_loss fwd+bwd"] - best["F.ctc_loss fwd"]
    out = {}
    for k, plain, lib in (("ctc_alpha", "plain fwd", best["F.ctc_loss fwd"]),
                          ("ctc_beta_grad", "plain bwd", lib_bwd)):
        least, by = ctc_cuda.bound_ms(*args, kernel=k)
        log(f"[kernel-ctc] {k} B={b} T'={t} L={l}: kernel {times[k]} ms, "
            f"plain {times[plain]} ms, bound {least:.6f} ms ({by}); "
            f"{best[k] / t * 1e3:.3f} us a frame ({card})")
        out[k] = {"max_abs_err": worst["nll"] if k == "ctc_alpha"
                  else worst["grad"],
                  "shape": f"B={b} T'={t} L={l} C=43 float32",
                  "ms": best[k], "plain_ms": best[plain], "bound_ms": least,
                  "bound_by": by, "library_ms": lib,
                  "ms_per_frame": best[k] / t}
    turns = frame_turns("beta_grad", parent, card)
    main = turns[f"B={b} T'={t}"]
    out["ctc_beta_grad"].update(
        chain_floor_ms=main["chain_floor_ms"], device_ms=min(main["ms"]),
        parent_ms=main["parent_ms"] and min(main["parent_ms"]), turns=turns)
    alpha_turns = frame_turns("alpha", parent, card)
    alpha_main = alpha_turns[f"B={b} T'={t}"]
    alpha_dev = min(alpha_main["ms"])
    out["ctc_alpha"].update(
        chain_floor_ms=alpha_main["chain_floor_ms"], device_ms=alpha_dev,
        parent_ms=alpha_main["parent_ms"] and min(alpha_main["parent_ms"]),
        turns=alpha_turns)
    log(f"[kernel-ctc] device time (CUDA-graph replays) at B={b} T'={t} "
        f"L={l}: ctc_alpha {alpha_dev:.4f} ms, {alpha_dev / t * 1e3:.3f} us "
        f"a frame; ctc_beta_grad {min(main['ms']):.4f} ms, "
        f"{main['us_per_frame']:.3f} us a frame, "
        f"{main['us_per_frame'] / (alpha_dev / t * 1e3):.2f}x ({card})")
    out["ctc_alpha"]["max_rel_err"] = worst["nll_rel"]
    out["ctc_alpha"]["call_ms"] = calls["ctc_alpha"]
    out["ctc_beta_grad"]["fwd_bwd_ms"] = best["ours fwd+bwd"]
    out["ctc_beta_grad"]["library_fwd_bwd_ms"] = best["F.ctc_loss fwd+bwd"]
    log(f"[kernel-ctc] F.ctc_loss (yardstick) forward "
        f"{times['F.ctc_loss fwd']} ms, forward + backward {times['F.ctc_loss fwd+bwd']} ms; the "
        f"port's loss forward + backward {times['ours fwd+bwd']} ms (CUDA "
        f"events, in turns); to a synchronize: ctc_alpha "
        f"{calls['ctc_alpha']:.4f}, F.ctc_loss forward "
        f"{calls['F.ctc_loss fwd']:.4f}, ours forward + backward "
        f"{calls['ours fwd+bwd']:.4f}, F.ctc_loss forward + backward "
        f"{calls['F.ctc_loss fwd+bwd']:.4f} ms ({card})")
    return out


def phase_kernel_lstm_parent(torch, parent) -> None:
    """lstm_fwd and lstm_bwd (the Pallas contract) against the parent
    tree's build of their sources, bit for bit, float32 and bfloat16, at
    train's, benchmark's and serving's shapes: the scan-contract instances
    beside them in the same files change none of their bits.  Not run
    without a parent tree."""
    from mdd_tpu_torch.ops import lstm_cuda

    if parent is None:
        log("[kernel-lstm-parent] no parent tree: not run")
        return
    old = [lstm_cuda.LstmFwdKernel(), lstm_cuda.LstmBwdKernel()]
    for k in old:
        k.source = str(parent / "mdd_tpu_torch" / "csrc" / k.source)
    g = torch.Generator().manual_seed(SEED + 50)
    for dtype in (torch.float32, torch.bfloat16):
        for t, b in ((80, BATCH), (80, 512), (16, 1)):
            x_proj = (torch.randn((t, 2, b, 4 * H), generator=g) * 0.5
                      ).to("cuda", dtype)
            w_hh = ((torch.rand((2, H, 4 * H), generator=g) * 2 - 1)
                    / H ** 0.5).to("cuda", dtype)
            dhs = torch.randn((t, 2, b, H), generator=g).cuda()
            new = lstm_cuda.lstm_fwd_kernel(x_proj, w_hh)
            got = new + lstm_cuda.lstm_bwd_kernel(x_proj, w_hh, *new, dhs)
            want = old[0](x_proj, w_hh)
            want += old[1](x_proj, w_hh, *new, dhs)
            same = all(torch.equal(a, w) for a, w in zip(got, want))
            log(f"[kernel-lstm-parent] {dtype} T'={t} B={b}: hs, cs, "
                f"dx_proj, dW_hh equal to the parent tree's kernels bit "
                f"for bit: {same}")
            if not same:
                raise AssertionError(f"lstm_fwd / lstm_bwd {dtype} T'={t} "
                                     f"B={b}: not the parent's bits")


#: phase kernel-scan: the text BiLSTM's (T = L, B): serving's L and B,
#: train's B=64, benchmark's L=48 at B=512 (the forward in one launch), a
#: ragged 513 and 1040 (past one launch of either recurrence); D=512
#: (text_embed_size), H=384
SCAN_SHAPES = ([(t, b) for t in (1, 7, 48) for b in (1, BATCH, 512, 513)]
               + [(48, 1040)])
SCAN_D = 512
SCAN_TOL = 2e-2   # scan kernels vs plain, each tensor relative to its
# largest magnitude: the same float32 steps in the same order but for the
# dots' sums (tensor cores against cuBLAS; the float32 dgates as three
# exact bfloat16 passes), so a rounding to bfloat16 (2^-8) can flip and
# carry through the later steps and dW_hh's bfloat16 sum
#: (T, B) at which the scan kernels are timed: benchmark's cell and train's
SCAN_TIMING = [(48, 512), (48, BATCH), (7, 1)]


def scan_inputs(torch, t: int, b: int, seed: int):
    """bfloat16 (x, w_ih_fwd, w_ih_bwd, x_proj, w_hh) on the card as the
    text BiLSTM makes them: a (T, B, 512) input through both directions'
    input projections."""
    from mdd_tpu_torch.ops.lstm import input_projections

    g = torch.Generator().manual_seed(seed)
    s = H ** -0.5
    x = torch.randn((t, b, SCAN_D), generator=g).to("cuda", torch.bfloat16)
    w_ih = [((torch.rand((SCAN_D, 4 * H), generator=g) * 2 - 1) * s).to(
        "cuda", torch.bfloat16) for _ in range(2)]
    w_hh = ((torch.rand((2, H, 4 * H), generator=g) * 2 - 1) * s).to(
        "cuda", torch.bfloat16)
    xf, xb = input_projections(x, *w_ih)
    return x, w_ih, torch.stack([xf, xb], dim=1).bfloat16(), w_hh


def lstm_scan_bound_ms(t: int, b: int, h: int) -> tuple:
    """Least time for the scan-contract forward: x_proj and w_hh (bf16)
    read once, hs (bf16) and cs (float32) written once; the recurrent dots
    at the bf16 rate plus the gate adds."""
    seq = t * 2 * b
    nbytes = 2 * (seq * 4 * h + 2 * h * 4 * h + seq * h) + 4 * seq * h
    flops = 2 * seq * h * 4 * h + seq * 4 * h + 4 * seq * h
    return bound(nbytes, flops, "bfloat16")


def lstm_scan_bwd_bound_ms(t: int, b: int, h: int) -> tuple:
    """Least time for the scan-contract backward: x_proj, w_hh, hs (bf16),
    cs and dhs (float32, as the kernel takes them) read once, dx_proj and
    dW_hh (bf16) written once.  Operations at the bf16 rate: the gate
    recompute's dots once, the two products of float32 dgates against
    bf16 operands (dh_{t-1}, dW_hh) three times each (a product exact to
    float32 takes a three-way split of the float32 operand), plus ~20
    operations of gate math per hidden unit and step."""
    seq = t * 2 * b
    nbytes = (2 * (seq * 4 * h + 2 * h * 4 * h + seq * h)
              + 4 * (2 * seq * h) + 2 * (seq * 4 * h + 2 * h * 4 * h))
    dot = 2 * seq * h * 4 * h
    return bound(nbytes, dot + 3 * 2 * dot + 20 * seq * h, "bfloat16")


def phase_kernel_scan(torch, card: str) -> dict:
    """lstm_scan_fwd and lstm_scan_bwd (csrc/lstm_scan.cu, the text
    BiLSTM's route in bfloat16) against their plain versions at
    SCAN_SHAPES (the backward on the plain forward's hs and cs and a bf16
    cotangent), each call's plans, the same bits twice at 48 x 513; then
    their times at SCAN_TIMING (CUDA events) beside the plain versions',
    their bounds and one bf16 torch.nn.LSTM(512, 384, bidirectional)
    layer as the yardstick, and their device times (CUDA-graph replays,
    ops/lstm_stamps.scan_turns) in turns with the parent tree's scan
    kernels (parent, tree, tree, parent) where it holds some that
    lstm_stamps.scan_bindings can bind.  -> the two `kernels` entries'
    numbers."""
    from mdd_tpu_torch.ops import lstm_stamps
    from mdd_tpu_torch.ops.lstm_cuda import (
        lstm_scan_bwd_kernel,
        lstm_scan_bwd_reference,
        lstm_scan_fwd_kernel,
        lstm_scan_fwd_reference,
    )
    from mdd_tpu_torch.utils.precision import strict_float32

    strict_float32("cuda", "float32")    # the plain versions' float32 dots
    worst = {"fwd": 0.0, "bwd": 0.0, "fwd_abs": 0.0, "bwd_abs": 0.0}
    for i, (t, b) in enumerate(SCAN_SHAPES):
        _, _, x_proj, w_hh = scan_inputs(torch, t, b, SEED + 10 + i)
        dhs = torch.randn((t, 2, b, H), generator=torch.Generator(
            ).manual_seed(i)).to("cuda", torch.bfloat16).float()
        before = (lstm_scan_fwd_kernel.launches, lstm_scan_bwd_kernel.launches)
        hs, cs = lstm_scan_fwd_kernel(x_proj, w_hh)
        ref_hs, ref_cs = lstm_scan_fwd_reference(x_proj, w_hh)
        dxp, dw = lstm_scan_bwd_kernel(x_proj, w_hh, ref_hs, ref_cs, dhs)
        torch.cuda.synchronize()
        ref_dxp, ref_dw = lstm_scan_bwd_reference(x_proj, w_hh, ref_hs,
                                                  ref_cs, dhs)
        fwd = [rel_err(hs, ref_hs), rel_err(cs, ref_cs)]
        bwd = [rel_err(dxp, ref_dxp),
               rel_err(dw, ref_dw) if t > 1 else float(dw.abs().max())]
        abs_err = [max((hs.float() - ref_hs.float()).abs().max().item(),
                       (cs - ref_cs).abs().max().item()),
                   max((dxp.float() - ref_dxp.float()).abs().max().item(),
                       (dw.float() - ref_dw.float()).abs().max().item())]
        same = ""
        if (t, b) == (48, 513):
            again = lstm_scan_fwd_kernel(x_proj, w_hh)
            again_b = lstm_scan_bwd_kernel(x_proj, w_hh, ref_hs, ref_cs, dhs)
            if not (torch.equal(hs, again[0]) and torch.equal(cs, again[1])
                    and torch.equal(dxp, again_b[0])
                    and torch.equal(dw, again_b[1])):
                raise AssertionError(f"the scan kernels at T={t} B={b} "
                                     "changed their bits between two runs")
            same = "; the same bits twice"
        plan = lstm_scan_fwd_kernel.plan(b, H, torch.bfloat16)
        plan_b = lstm_scan_bwd_kernel.plan(t, b, H, torch.bfloat16)
        log(f"  lstm_scan T={t} B={b}: fwd max rel err hs {fwd[0]:.3e}, cs "
            f"{fwd[1]:.3e}; bwd dx_proj {bwd[0]:.3e}, dW_hh {bwd[1]:.3e}; "
            f"max abs err fwd {abs_err[0]:.3e}, bwd {abs_err[1]:.3e}{same}; "
            f"forward plan {plan}; backward plan {plan_b}")
        if not (max(fwd) <= SCAN_TOL and max(bwd) <= SCAN_TOL
                and hs.dtype == dxp.dtype == dw.dtype == torch.bfloat16
                and cs.dtype == torch.float32):
            raise AssertionError(f"the scan kernels at T={t} B={b} differ "
                                 f"from their plain versions: fwd {fwd}, "
                                 f"bwd {bwd} (tol {SCAN_TOL})")
        launched = (lstm_scan_fwd_kernel.launches - before[0],
                    lstm_scan_bwd_kernel.launches - before[1])
        if launched != ((2, 2) if same else (1, 1)):
            raise AssertionError(f"scan kernels counted {launched}")
        worst["fwd"] = max(worst["fwd"], *fwd)
        worst["bwd"] = max(worst["bwd"], *bwd)
        worst["fwd_abs"] = max(worst["fwd_abs"], abs_err[0])
        worst["bwd_abs"] = max(worst["bwd_abs"], abs_err[1])
        if t == 1 and (dw.any() or ref_dw.any()):
            raise AssertionError("dW_hh of one step (no h_{t-1}) is not 0")
    log(f"[kernel-scan] lstm_scan_fwd / lstm_scan_bwd match their plain "
        f"versions at {len(SCAN_SHAPES)} shapes: max rel err "
        f"{worst['fwd']:.3e} / {worst['bwd']:.3e} (tol {SCAN_TOL})")
    out = {"lstm_scan_fwd": {"max_abs_err": worst["fwd_abs"],
                             "max_rel_err": worst["fwd"], "by_shape": {}},
           "lstm_scan_bwd": {"max_abs_err": worst["bwd_abs"],
                             "max_rel_err": worst["bwd"], "by_shape": {}}}
    parent = parent_tree()
    old = parent and lstm_stamps.scan_bindings(parent)
    for i, (t, b) in enumerate(SCAN_TIMING):
        x, _, x_proj, w_hh = scan_inputs(torch, t, b, SEED + 30 + i)
        dhs = torch.randn((t, 2, b, H), device="cuda").bfloat16().float()
        lib = torch.nn.LSTM(SCAN_D, H, bidirectional=True).to(
            "cuda", torch.bfloat16)
        x_grad = x.clone().requires_grad_()
        dy = torch.randn((t, b, 2 * H), device="cuda").bfloat16()
        with torch.no_grad():
            hs, cs = lstm_scan_fwd_kernel(x_proj, w_hh)
            k = lstm_scan_bwd_kernel
            buffers = k.buffers(x_proj)
            fns = {"fwd": lambda: lstm_scan_fwd_kernel(x_proj, w_hh),
                   "bwd": lambda: k(x_proj, w_hh, hs, cs, dhs),
                   "plain fwd": lambda: lstm_scan_fwd_reference(x_proj, w_hh),
                   "plain bwd": lambda: lstm_scan_bwd_reference(
                       x_proj, w_hh, hs, cs, dhs)}
            fns.update({f"bwd {name}": (lambda part=part: k.run_parts(
                x_proj, w_hh, hs, cs, dhs, buffers, part))
                for name, part in (("z", k.Z_PRODUCT), ("chain", k.CHAIN),
                                   ("dw", k.DW_PRODUCT))})
            times = {name: cuda_ms(fn, 3 if name.startswith("plain") else 20)
                     for name, fn in fns.items()}
        # a call's time (events) and its device time (CUDA-graph replays)
        # in turns with the parent tree's kernels: parent, tree, tree,
        # parent
        turns = {name: lstm_stamps.scan_turns(f"scan-{name}", b, t,
                                              old and parent, H)
                 for name in ("fwd", "bwd")}
        lib_fwd = cuda_ms(lambda: lib(x_grad)[0], 20)
        lib_both = cuda_ms(lambda: lib(x_grad)[0].backward(dy), 20)
        shape = f"T={t} B={b}"
        for name, bnd_fn, lib_ms in (
                ("fwd", lstm_scan_bound_ms, lib_fwd),
                ("bwd", lstm_scan_bwd_bound_ms, lib_both - lib_fwd)):
            least, by = bnd_fn(t, b, H)
            entry = {"ms": times[name], "plain_ms": times[f"plain {name}"],
                     "bound_ms": least, "bound_by": by, "library_ms": lib_ms,
                     "turns": turns[name]}
            if name == "bwd":
                entry["parts_ms"] = {p: times[f"bwd {p}"]
                                     for p in ("z", "chain", "dw")}
            out[f"lstm_scan_{name}"]["by_shape"][shape] = entry
        plan = lstm_scan_fwd_kernel.plan(b, H, torch.bfloat16)
        plan_b = lstm_scan_bwd_kernel.plan(t, b, H, torch.bfloat16)
        log(f"[kernel-scan] {shape} D={SCAN_D} H={H} bfloat16: lstm_scan_fwd "
            f"{times['fwd']:.4f} ms in {plan['launches']} launch(es) of "
            f"{plan['blocks']} blocks of {plan['tiles_per_block']} tiles "
            f"(plain {times['plain fwd']:.4f}, bound "
            f"{lstm_scan_bound_ms(t, b, H)[0]:.6f}); lstm_scan_bwd "
            f"{times['bwd']:.4f} ms (pre-activation product "
            f"{times['bwd z']:.4f}, recurrence {times['bwd chain']:.4f} in "
            f"{plan_b['launches']} launch(es) of {plan_b['blocks']} blocks "
            f"of {plan_b['tiles_per_block']} tiles, dW_hh "
            f"{times['bwd dw']:.4f}; plain {times['plain bwd']:.4f}, "
            f"bound {lstm_scan_bwd_bound_ms(t, b, H)[0]:.6f}); yardstick "
            f"torch.nn.LSTM({SCAN_D}, {H}, bidirectional) bf16 (cuDNN, "
            f"another contract: c in float32, its own roundings; the input "
            f"projection included) forward {lib_fwd:.4f} ms, backward "
            f"{lib_both - lib_fwd:.4f} ms ({card})")
        log(f"[kernel-scan] {shape} a call (events) / its device time "
            f"(CUDA-graph replays)"
            + "".join(f"; lstm_scan_{n} tree {v['call_ms']} / {v['ms']} ms"
                      + (f", parent {v['parent_call_ms']} / "
                         f"{v['parent_ms']} ms" if old else "")
                      for n, v in turns.items())
            + (" (in turns: parent, tree, tree, parent)" if old else
               "; the parent tree holds no scan kernels this package can "
               "call: no turns" if parent else "; no parent tree: no turns")
            + f" ({card})")
    for name in out:
        main = out[name]["by_shape"][f"T={SCAN_TIMING[0][0]} "
                                     f"B={SCAN_TIMING[0][1]}"]
        out[name].update(shape=f"T={SCAN_TIMING[0][0]} B={SCAN_TIMING[0][1]}"
                         f" D={SCAN_D} H={H} bfloat16",
                         **{k: v for k, v in main.items()
                            if k not in ("parts_ms", "turns")})
    return out


def beam_inputs(torch, b: int, t: int, c: int, seed: int, lm: bool,
                case: str):
    """Seeded log-probs (blank-boosted, or one-hot clamped at 1e-38 as
    BatchedBeamDecoder.decode clamps), lengths and an LM matrix on the
    card: a Witten-Bell bigram trained on seeded sentences, times 0.5;
    "ties" rounds the log-probs and the LM to multiples of 0.5, so that
    many candidates tie and the index order decides."""
    import numpy as np

    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.decode import lm_train
    from mdd_tpu_torch.decode.arpa import ArpaBigramLM

    rng = np.random.default_rng(SEED + 200 + seed)
    if case == "peaky":
        ids = rng.integers(0, c, (b, t))
        ids[rng.random((b, t)) < 0.5] = 0
        probs = np.zeros((b, t, c), np.float32)
        np.put_along_axis(probs, ids[..., None], 1.0, -1)
        lp = np.log(np.maximum(probs, 1e-38))
    else:
        logits = rng.standard_normal((b, t, c)).astype(np.float32)
        logits[:, :, 0] += 1.5
        lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    if case == "ties":
        lp = np.round(lp * 2) / 2
    lengths = (rng.integers(0, t + 1, b) if case == "ragged"
               else np.full(b, t))
    vocab = Vocab([f"p{i}" for i in range(c - 2)])
    if lm:
        path = WORK / f"kernel_beam_lm_{c}.arpa"
        if not path.exists():
            units = vocab.units()
            counts = lm_train.BigramCounts()
            counts.add_corpus([[units[i] for i in rng.integers(
                0, len(units), rng.integers(8, 30))] for _ in range(400)])
            WORK.mkdir(parents=True, exist_ok=True)
            lm_train.write_arpa(*lm_train.witten_bell_bigram(counts),
                                str(path))
        matrix = ArpaBigramLM(str(path)).dense_matrix(vocab.index2word) * 0.5
        if case == "ties":
            matrix = np.round(matrix * 2) / 2
    else:
        matrix = np.zeros((c + 1, c + 1), np.float32)
    return (torch.from_numpy(lp.astype(np.float32)).cuda(),
            torch.from_numpy(lengths.astype(np.int64)).cuda(),
            torch.from_numpy(np.asarray(matrix, np.float32)).cuda(), vocab)


def phase_kernel_beam(torch, card: str) -> dict:
    """ctc_beam against decode/beam_jit.beam_search_batch on the card (every
    sequence and normalised score bit for bit) and the parent tree's
    kernel (the same bits), and against the host beam; its time against
    the plain loop's, and in turns with the parent's at TURN_SHAPES."""
    import numpy as np

    from mdd_tpu_torch.align.levenshtein import edit_distance
    from mdd_tpu_torch.decode.beam import BeamSearchDecoder
    from mdd_tpu_torch.decode.beam_jit import beam_search_batch
    from mdd_tpu_torch.ops import beam_cuda, frame_stamps

    kernel = beam_cuda.ctc_beam_kernel
    parent = parent_tree()
    parent_kernel = parent and frame_stamps.binding(
        "beam", frame_stamps.parent_source("beam", parent))
    rows = same = bits = errs = tokens = 0
    worst = 0.0
    timing = None
    for name, b, t, c, k, seed, lm, case in BEAM_CASES:
        lp, lengths, matrix, vocab = beam_inputs(torch, b, t, c, seed, lm,
                                                 case)
        before = kernel.launches
        pre, lens, score = kernel(lp, lengths, matrix, k, 0, 0.1, scores=True)
        pre2, lens2 = kernel(lp, lengths, matrix, k, 0, 0.1)
        torch.cuda.synchronize()
        if kernel.launches != before + 2 or not (
                torch.equal(pre, pre2) and torch.equal(lens, lens2)):
            raise AssertionError(f"ctc_beam {name}: not the same from run "
                                 "to run, or not one launch a call")
        ref, ref_lens, ref_score = beam_search_batch(
            lp, lengths, matrix, k, 0, 0.1, int(lengths.max()),
            return_scores=True)
        got = [pre[i, :lens[i]].tolist() for i in range(b)]
        want = [ref[i, :ref_lens[i]].tolist() for i in range(b)]
        tails = bool((pre * (torch.arange(t, device=pre.device)[None]
                             >= lens[:, None])).eq(0).all())
        n_same = sum(x == y for x, y in zip(got, want))
        n_bits = int((score.view(torch.int32)
                      == ref_score.view(torch.int32)).sum())
        n_err = sum(edit_distance(x, y)[0] for x, y in zip(got, want))
        worst = max(worst, (score - ref_score).abs().max().item())
        rows += b
        same += n_same
        bits += n_bits
        errs += n_err
        tokens += sum(len(y) for y in want)
        same_parent = parent_kernel is None or all(
            torch.equal(x, y) for x, y in zip(
                (pre, lens, score),
                parent_kernel(lp, lengths, matrix, k, 0, 0.1, scores=True)))
        log(f"[kernel-beam] {name} (B={b}, T'={t}, C={c}, K={k}"
            f"{', LM 0.5' if lm else ''}): {n_same} / {b} sequences identical "
            f"to the plain version's, {n_bits} / {b} scores equal bit for "
            f"bit, {n_err} token edits; zeros after each prefix: {tails}; "
            + ("no parent tree" if parent_kernel is None else
               f"the parent's kernel's bits: {same_parent}"))
        for i in range(b):
            if got[i] != want[i]:
                log(f"[kernel-beam]   row {i}: kernel {got[i]} score "
                    f"{score[i].item()!r}; plain {want[i]} score "
                    f"{ref_score[i].item()!r}")
        if not tails:
            raise AssertionError(f"ctc_beam {name}: non-zero labels past a "
                                 "prefix")
        if n_same != b or n_bits != b or not same_parent:
            raise AssertionError(f"ctc_beam {name}: {n_same} / {b} "
                                 f"sequences and {n_bits} / {b} scores "
                                 "equal to the plain version's; the "
                                 f"parent's bits: {same_parent}")
        if name == "profile-evaluate":
            host = BeamSearchDecoder(vocab.index2word, beam_width=k)
            probs = torch.exp(lp[:HOST_ROWS]).double().cpu().numpy()
            hosted = host.decode(probs, lengths[:HOST_ROWS].tolist())
            share = sum(x == y for x, y in zip(got, hosted)) / HOST_ROWS
            log(f"[kernel-beam] {name}: the first {HOST_ROWS} rows "
                f"{100 * share:.1f}% identical to the host beam (bar "
                f"{100 * BEAM_MATCH:.0f}%)")
            if share < BEAM_MATCH:
                raise AssertionError("ctc_beam disagrees with the host beam")
            timing = (lp, lengths, matrix, k, t)
    share, err = same / rows, errs / max(tokens, 1)
    log(f"[kernel-beam] all cases: {same} / {rows} sequences identical "
        f"({100 * share:.2f}%, bar {100 * BEAM_IDENTICAL:.0f}%), {bits} / "
        f"{rows} normalised scores equal bit for bit (largest difference "
        f"{worst!r}), token error {err:.6f} (bar {BEAM_TOKEN_ERR})")
    if share < BEAM_IDENTICAL or err > BEAM_TOKEN_ERR:
        raise AssertionError("ctc_beam disagrees with its plain version")

    lp, lengths, matrix, k, t = timing
    kern = lambda: kernel(lp, lengths, matrix, k, 0, 0.1)
    plain = lambda: beam_search_batch(lp, lengths, matrix, k, 0, 0.1, t)
    times = {"kernel": [], "plain": []}
    for which, fn in (("kernel", kern), ("plain", plain), ("plain", plain),
                      ("kernel", kern)):
        times[which].append(cuda_ms(fn, 50 if which == "kernel" else 3,
                                    warmup=1))
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    least, by = beam_cuda.bound_ms(lp, lengths, matrix, k, 0, 0.1)
    kept = int(beam_cuda.kept_frames(lp, lengths, 0, 0.1).max())
    log(f"[kernel-beam] B={lp.shape[0]} T'={t} C={lp.shape[2]} K={k}: kernel "
        f"{times['kernel']} ms, plain {times['plain']} ms (CUDA events, in "
        f"turns); {ms / t * 1e3:.3f} us a frame ({ms / kept * 1e3:.3f} a kept "
        f"frame of the longest row, {kept}); bound {least:.6f} ms ({by}) "
        f"({card})")
    turns = frame_turns("beam", parent, card)
    main = turns[f"B={lp.shape[0]} T'={t}"]
    return {"max_abs_err": worst, "identical_share": share,
            "token_error": err, "scores_bit_equal": bits / rows,
            "shape": f"B={lp.shape[0]} T'={t} C={lp.shape[2]} K={k} float32",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": least,
            "bound_by": by, "library_ms": None, "ms_per_frame": ms / t,
            "chain_floor_ms": main["chain_floor_ms"],
            "device_ms": min(main["ms"]),
            "parent_ms": main["parent_ms"] and min(main["parent_ms"]),
            "turns": turns}


def phase_model(torch):
    from mdd_tpu_torch.convert import flax_to_torch, random_flax_variables
    from mdd_tpu_torch.models.ctc_model import (
        CTCAttentionModel,
        model_config_from_meta,
    )

    from mdd_tpu_torch.utils.precision import strict_float32

    meta = json.loads((ROOT / "checkpoints" / "syn_full"
                       / "best.meta.json").read_text())
    cfg = model_config_from_meta(meta)
    strict_float32("cuda", cfg.compute_dtype)   # the model outside EvalSession
    if not cfg.use_pallas_lstm:
        raise AssertionError("the flagship config runs the fused LSTM")
    state = flax_to_torch(*random_flax_variables(cfg, SEED))
    models = {}
    for name, use in (("kernel", True), ("plain", False)):
        m = CTCAttentionModel(dataclasses.replace(cfg, use_pallas_lstm=use))
        m.load_state_dict(state, strict=True)
        models[name] = m.to("cuda").eval()
    rng = torch.Generator().manual_seed(SEED)
    b, t, l = 4, 160, 16
    feats = torch.randn((b, t, cfg.input_dim), generator=rng).cuda()
    trans = torch.randint(2, cfg.num_class, (b, l), generator=rng).cuda()
    lengths = torch.tensor([16, 11, 5, 1]).cuda()
    with torch.inference_mode():
        out = {k: m(feats, trans, lengths) for k, m in models.items()}
    lp = out["kernel"]
    want = (cfg.output_frames(t), b, cfg.num_class)
    if tuple(lp.shape) != want or not torch.isfinite(lp).all():
        raise AssertionError(f"log-probs {tuple(lp.shape)} (want {want}) "
                             "or not finite")
    err = (lp - out["plain"]).abs().max().item()
    log(f"[model] full-width CTCAttentionModel ({models['kernel'].num_params()}"
        f" params), B={b} T'={want[0]}: kernel vs plain LSTM log-probs max "
        f"err {err:.3e} (tol {MODEL_TOL})")
    if not err <= MODEL_TOL:
        raise AssertionError(f"model log-probs differ by {err}")
    return cfg, meta, state


# mdd_tpu's capture of the flagship model (4 BiLSTM layers): its
# _flatten_intermediates keeps the first 6 three-dimensional entries
VIS_NAMES = ["conv/__call__", "rnn0/drop/__call__", "rnn0/__call__",
             "rnn1/bn/__call__", "rnn1/drop/__call__", "rnn1/__call__"]


def phase_visualize(torch, cfg, state, card: str) -> dict:
    """utils/visualize.capture_activations on the full-width model with
    phase model's weights, one utterance of T'=80 on the kernel against
    the plain LSTM; then visualize_utterance's plots or its ImportError;
    -> the launches of the capture by kernel."""
    import numpy as np

    from mdd_tpu_torch.models.ctc_model import CTCAttentionModel
    from mdd_tpu_torch.ops.dropout_cuda import fused_dropout_kernel
    from mdd_tpu_torch.ops.lstm_cuda import lstm_bwd_kernel, lstm_fwd_kernel
    from mdd_tpu_torch.utils import visualize
    from mdd_tpu_torch.utils.precision import strict_float32

    strict_float32("cuda", cfg.compute_dtype)
    models = {}
    for name, use in (("kernel", True), ("plain", False)):
        m = CTCAttentionModel(dataclasses.replace(cfg, use_pallas_lstm=use))
        m.load_state_dict(state, strict=True)
        models[name] = m.to("cuda")
    rng = np.random.default_rng(SEED + 5)
    t = 160                                   # T' = 80
    feats = rng.standard_normal((t, cfg.input_dim)).astype(np.float32)
    trans = rng.integers(2, cfg.num_class, 24)
    kernels = {"lstm_fwd": lstm_fwd_kernel, "lstm_bwd": lstm_bwd_kernel,
               "fused_dropout": fused_dropout_kernel}
    for k in kernels.values():
        k.launches = 0
    lp, acts = visualize.capture_activations(models["kernel"], feats, trans)
    launches = {n: k.launches for n, k in kernels.items()}
    ref_lp, ref = visualize.capture_activations(models["plain"], feats, trans)
    t_out = cfg.output_frames(t)
    if (list(acts) != VIS_NAMES or list(ref) != VIS_NAMES
            or lp.shape != (t_out, 1, cfg.num_class)
            or not all(a.shape[:2] == (1, t_out) for a in acts.values())
            or not np.isfinite(lp).all()):
        raise AssertionError(f"[visualize] captured {list(acts)} "
                             f"{[a.shape for a in acts.values()]}, "
                             f"log-probs {lp.shape}: not {VIS_NAMES}")
    errs = {"log-probs": float(np.abs(lp - ref_lp).max())}
    errs.update({n: float(np.abs(acts[n] - ref[n]).max()) for n in acts})
    worst = max(errs, key=errs.get)
    log(f"[visualize] capture_activations, full width, T'={t_out}, 24 "
        f"canonical phones: {list(acts)}; kernel vs plain LSTM max abs err "
        f"{errs[worst]:.3e} at {worst} (tol {MODEL_TOL}); launches {launches}"
        f" ({card})")
    if not errs[worst] <= MODEL_TOL:
        raise AssertionError(f"[visualize] kernel and plain captures "
                             f"differ: {errs}")
    if launches != {"lstm_fwd": lstm_per_pass(), "lstm_bwd": 0,
                    "fused_dropout": 0}:
        raise AssertionError(f"[visualize] launches {launches}: a layer "
                             "of the forward bypassed lstm_fwd")
    out = WORK / "visualize"
    id2word = {i: f"p{i}" for i in range(cfg.num_class)}
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        try:
            visualize.visualize_utterance(models["kernel"], feats, trans,
                                          id2word, str(out))
        except ImportError as e:
            if "matplotlib" not in str(e):
                raise AssertionError(f"[visualize] ImportError without "
                                     f"matplotlib's name: {e}") from None
            log(f"[visualize] no matplotlib here: visualize_utterance "
                f"raises ImportError({e})")
        else:
            raise AssertionError("[visualize] visualize_utterance drew "
                                 "without matplotlib")
    else:
        paths = visualize.visualize_utterance(models["kernel"], feats, trans,
                                              id2word, str(out))
        small = [p for p in paths if os.path.getsize(p) <= 1000]
        if len(paths) != 8 or small:
            raise AssertionError(f"[visualize] {len(paths)} PNGs, "
                                 f"{small} of 1000 bytes or less")
        log(f"[visualize] visualize_utterance wrote {len(paths)} PNGs")
    return launches


def write_serving_files(cfg, meta, state) -> dict:
    """Wavs, units, CMVN, config and checkpoint under WORK."""
    import numpy as np

    from mdd_tpu_torch.frontend.cmvn import CmvnStats, write_kaldi_cmvn_text
    from mdd_tpu_torch.frontend.pipeline import BatchedFbank
    from mdd_tpu_torch.frontend.wav import read_audio, write_wav
    from mdd_tpu_torch.train.checkpoint import save_checkpoint

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    rng = np.random.default_rng(SEED)
    paths = []
    for i, secs in enumerate(np.linspace(0.6, 3.2, 8)):
        n = int(secs * 16000)
        tt = np.arange(n) / 16000.0
        sig = sum(a * np.sin(2 * np.pi * f * tt) for a, f in
                  zip(rng.uniform(500, 4000, 3), rng.uniform(100, 3000, 3)))
        sig = sig * np.hanning(n) + 300 * rng.standard_normal(n)
        path = str(WORK / f"w{i}.wav")
        write_wav(path, sig.astype(np.float32), 16000)
        paths.append(path)
    (WORK / "units").write_text("\n".join(UNITS) + "\n")
    feats = BatchedFbank(device="cuda")([read_audio(p)[0] for p in paths])
    write_kaldi_cmvn_text(CmvnStats.accumulate(feats), str(WORK / "cmvn.txt"))
    save_checkpoint(str(WORK / "ckpt"), "best", state,
                    {"model_config": meta["model_config"]})
    (WORK / "serve.yaml").write_text(
        f"exp_name: smoke\nvocab_file: {WORK / 'units'}\n"
        "decode_type: Greedy\nleft_ctx: 0\nright_ctx: 2\n"
        "n_skip_frame: 2\nn_downsample: 2\n")
    canon = [[UNITS[k] for k in rng.integers(2, len(UNITS), rng.integers(3, 9))]
             for _ in paths]
    dict_dir, ecdict = write_lexicon()
    return {"paths": paths, "canonical": canon, "dict_dir": dict_dir,
            "ecdict": ecdict,
            "args": ["serve", "--conf", str(WORK / "serve.yaml"),
                     "--checkpoint", str(WORK / "ckpt"),
                     "--cmvn", str(WORK / "cmvn.txt"), "--dict-dir", dict_dir,
                     "--ecdict-csv", ecdict, "--device", "cuda"]}


def request(files, i, rid=None) -> str:
    return json.dumps({"id": rid if rid is not None else i,
                       "wav": files["paths"][i], "word": f"w{i}",
                       "canonical": files["canonical"][i]})


def check_ok(resps, n, lowest: int = 0) -> None:
    """n answers, each ok with its fields and a score of lowest..100
    (word_score's formula goes down to -10 where insertions pile onto a
    word whose every phone is wrong)."""
    if len(resps) != n:
        raise AssertionError(f"{len(resps)} responses to {n} requests")
    for r in resps:
        if r.get("status") != "ok" or not {
                "score", "canonical_row", "ops_row", "decoded_row",
                "insertion_faults", "substitution_faults",
                "deletion_faults"} <= r.keys() or not (
                    lowest <= r["score"] <= 100):
            raise AssertionError(f"bad response {r}")


def phase_serve(files, card: str):
    """The main path, on requests that carry their canonical phones;
    returns (the kernel launches it made, the engine)."""
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.ops.lstm_cuda import lstm_fwd_kernel
    from mdd_tpu_torch.serve import handle_requests

    n_files = len(files["paths"])
    lstm_fwd_kernel.launches = 0
    # (a) the serve subcommand, as `python -m mdd_tpu_torch serve` runs it
    lines = [request(files, i % n_files, rid=i) for i in range(2 * n_files)]
    out, err = io.StringIO(), io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO("\n".join(lines) + "\n")
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(files["args"] + ["--quiet"])
    finally:
        sys.stdin = stdin
    if rc != 0:
        raise AssertionError(f"serve exited {rc}: {err.getvalue()}")
    check_ok([json.loads(l) for l in out.getvalue().splitlines()], len(lines))
    tail = err.getvalue().strip().splitlines()[-1]
    cli_forwards = int(tail.split(" in ")[1].split()[0])
    log(f"[serve] subcommand: {len(lines)} requests ok; {tail}")
    # (b) the engine it builds, on groups of 1, 4 and 16 requests
    engine = cli._build_engine(cli.build_parser().parse_args(files["args"]))
    engine.warmup()
    singles = []
    for i in range(n_files):
        t0 = time.perf_counter()
        resps = handle_requests(engine, [request(files, i)])
        singles.append(time.perf_counter() - t0)
        check_ok(resps, 1)
    for size in (4, 16):
        group = [request(files, n_files // 2, rid=k) for k in range(size)]
        t0 = time.perf_counter()
        resps = handle_requests(engine, group)
        dt = time.perf_counter() - t0
        check_ok(resps, size)
        if {r["batch"] for r in resps} != {size}:
            raise AssertionError("group was not served as one batch")
        log(f"[serve] batch of {size}: {dt * 1e3:.2f} ms for the group "
            f"({card})")
    resps = handle_requests(engine, [request(files, i)
                                     for i in range(n_files)])
    check_ok(resps, n_files)
    forwards = cli_forwards + engine.session.forwards
    launches = lstm_fwd_kernel.launches
    log(f"[serve] p50 request latency, batch 1, wavs 0.6-3.2 s: "
        f"{statistics.median(singles) * 1e3:.2f} ms ({card})")
    log(f"[serve] lstm_fwd launches {launches} over {forwards} model "
        f"forwards ({lstm_per_pass()} BiLSTM layers each)")
    if launches < lstm_per_pass() * forwards or forwards == 0:
        raise AssertionError(f"{launches} kernel launches for {forwards} "
                             "forwards: a layer bypassed the kernel")
    # batch-1 p50 with the text BiLSTM on the kernels against the plain
    # loop, in turns (after the launch count: these are not counted)
    from mdd_tpu_torch.ops.lstm import bilstm

    text = engine.session.model.text.lstm
    kernel_rnn = text.rnn
    p50 = {"kernels": [], "plain loop": []}
    try:
        for which in ("kernels", "plain loop", "plain loop", "kernels"):
            text.rnn = kernel_rnn if which == "kernels" else bilstm
            turn = []
            for i in range(2 * n_files):
                t0 = time.perf_counter()
                check_ok(handle_requests(engine, [request(files,
                                                          i % n_files)]), 1)
                turn.append(time.perf_counter() - t0)
            p50[which].append(round(statistics.median(turn) * 1e3, 3))
    finally:
        text.rnn = kernel_rnn
    log(f"[serve] p50 batch-1 latency with the text BiLSTM on the kernels "
        f"{p50['kernels']} ms, on the plain loop {p50['plain loop']} ms (in "
        f"turns, {2 * n_files} requests each) ({card})")
    return launches, engine


# phase lexicon: the CMUdict lines (public domain) of the prompt words, their
# IPA entries, letter-group phonics and ECDICT rows, typed in; "zorblat" is in
# no dictionary (the rule fallback)
LEX_WORDS = ["about", "gather", "vocabulary", "magazine", "through", "accept",
             "talked", "bananas", "zorblat"]
LEX_CMUDICT = """\
about AH0 B AW1 T
accept AE0 K S EH1 P T
accept(2) AH0 K S EH1 P T
bananas B AH0 N AE1 N AH0 Z
gather G AE1 DH ER0
magazine M AE1 G AH0 Z IY2 N
magazine(2) M AE2 G AH0 Z IY1 N
talked T AO1 K T
through TH R UW1
vocabulary V OW0 K AE1 B Y AH0 L EH2 R IY0
"""
LEX_IPA = """\
ABOUT\təˈbaʊt
ACCEPT\tækˈsɛpt, əkˈsɛpt
BANANAS\tbəˈnænəz
GATHER\tˈɡæðɚ
MAGAZINE\tˈmæɡəˌzin, ˌmæɡəˈzin
TALKED\tˈtɔkt
THROUGH\tˈθru
VOCABULARY\tvoʊˈkæbjəˌlɛri
"""
LEX_PHONICS = """\
about\t1\tə.ˈbaʊt\ta-ə,b-b,ou-aʊ,t-t
gather\t2\tˈgæ.ðər\tg-g,a-æ,th-ð,er-ər
through\t3\tθru\tth-θ,r-r,ough-u
talked\t4\ttɔkt\tt-t,al-ɔ,k-k,ed-t
"""
LEX_ECDICT = """\
word,phonetic,definition,translation
about,ə'baut,adv. around,adv. 大约\\nprep. 关于
gather,'gæðə,v. collect,v. 聚集；收集
vocabulary,və'kæbjuləri,n. words,n. 词汇；单词表
magazine,mægə'zi:n,n. periodical,n. 杂志
through,θru:,prep. via,prep. 通过
"""
CMUDICT_ENTRIES = 135_000   # CMUdict 0.7b's size, for the cold-start load


def write_lexicon() -> tuple:
    """The dictionary files under WORK/dict -> (dict dir, ECDICT csv)."""
    d = WORK / "dict"
    d.mkdir()
    for name, text in (("cmudict.dict", LEX_CMUDICT),
                       ("cmudict-0.7b-ipa.txt", LEX_IPA),
                       ("phonics_engine.csv", LEX_PHONICS),
                       ("ecdict.csv", LEX_ECDICT)):
        (d / name).write_text(text, encoding="utf-8")
    return str(d), str(d / "ecdict.csv")


def write_big_lexicon(n: int) -> tuple:
    """A seeded dictionary pair of n entries in CMUdict's two formats ->
    (its dir, one of its words)."""
    import numpy as np

    from mdd_tpu_torch.lexicon.dictionary import (CMU_CONSONANTS, CMU_VOWELS,
                                                  phones39_to_ipa)

    rng = np.random.default_rng(SEED)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    inventory = ([v + "1" for v in CMU_VOWELS if v not in ("AH0", "ER0")]
                 + ["AH0", "ER0"] + CMU_CONSONANTS)
    plain, ipa = [], []
    for i in range(n):
        word = "".join(letters[rng.integers(0, 26, rng.integers(3, 12))])
        word = f"{word}{i}"   # unique
        phones = [inventory[k] for k in
                  rng.integers(0, len(inventory), rng.integers(2, 10))]
        plain.append(f"{word} {' '.join(phones)}\n")
        ipa.append(f"{word.upper()}\t{''.join(phones39_to_ipa(phones))}\n")
    d = WORK / "dict_big"
    d.mkdir()
    (d / "cmudict.dict").write_text("".join(plain), encoding="utf-8")
    (d / "cmudict-0.7b-ipa.txt").write_text("".join(ipa), encoding="utf-8")
    return str(d), plain[n // 2].split(" ")[0]


def report_rows(text: str) -> list:
    """diagnose_dir's printed reports -> [(utt id, canonical phones)]: each
    report starts with "id     : N"; its canonical row less the 'I' slots
    of insertions."""
    out = []
    for block in text.split("id     : ")[1:]:
        lines = block.splitlines()
        row = next(l for l in lines if l.startswith("canonical : "))
        out.append((lines[0].strip(),
                    [p for p in row.split()[2:] if p != "I"]))
    return out


def phase_lexicon(torch, files, card: str) -> dict:
    """`infer` over N.wav + N.txt pairs three ways and `serve` with
    word-only requests, the canonical phones, IPA, translation and phonics
    from the port's lexicon; -> lstm_fwd launches by path."""
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.infer import read_phonemes_from_textgrid
    from mdd_tpu_torch.lexicon.dictionary import CMU_TO_IPA_WIKI, Phonetic
    from mdd_tpu_torch.ops.lstm_cuda import lstm_fwd_kernel
    from mdd_tpu_torch.serve import handle_requests

    dict_dir, ecdict = files["dict_dir"], files["ecdict"]
    lexicon = Phonetic(dict_dir, ecdict)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        canon = {w: lexicon.canonical_model_phones(w) for w in LEX_WORDS}
    pairs = WORK / "pairs"
    tgs = WORK / "textgrids"
    pairs.mkdir()
    tgs.mkdir()
    n_files = len(files["paths"])
    for n, word in enumerate(LEX_WORDS, 1):
        shutil.copy(files["paths"][(n - 1) % n_files], pairs / f"{n}.wav")
        (pairs / f"{n}.txt").write_text(word + "\n")
        # the prompt's CMUdict phones between two silences ("zorblat":
        # phones typed in)
        cmu = lexicon.cmu_dict(word) or "Z AO1 R B L AE2 T"
        marks = [""] + cmu.split(" ") + [""]
        step = 1.0 / len(marks)
        ivs = "".join(
            f'        intervals [{i + 1}]:\n            xmin = {i * step}\n'
            f'            xmax = {(i + 1) * step}\n            text = "{m}"\n'
            for i, m in enumerate(marks))
        (tgs / f"{n}.TextGrid").write_text(
            'File type = "ooTextFile"\nObject class = "TextGrid"\n\nxmin = 0\n'
            'xmax = 1\ntiers? <exists>\nsize = 2\nitem []:\n'
            '    item [1]:\n        class = "IntervalTier"\n'
            '        name = "words"\n        xmin = 0\n        xmax = 1\n'
            '        intervals: size = 1\n        intervals [1]:\n'
            f'            xmin = 0\n            xmax = 1\n'
            f'            text = "{word}"\n'
            '    item [2]:\n        class = "IntervalTier"\n'
            '        name = "phones"\n        xmin = 0\n        xmax = 1\n'
            f'        intervals: size = {len(marks)}\n' + ivs)
    base = ["infer", "--wav-transcript-path", str(pairs), "--conf",
            str(WORK / "serve.yaml"), "--checkpoint", str(WORK / "ckpt"),
            "--cmvn", str(WORK / "cmvn.txt"), "--dict-dir", dict_dir,
            "--ecdict-csv", ecdict, "--device", "cuda"]
    dump = WORK / "decode_seq.txt"
    n_pairs = len(LEX_WORDS)

    # (b) infer, three ways
    lstm_fwd_kernel.launches = 0
    t0 = time.perf_counter()
    runs = {"dump": run_cli(base + ["--decode-dump", str(dump)]),
            "ipa": run_cli(base + ["--phonetic-format", "ipa",
                                   "--forgiving", "1"]),
            "textgrid": run_cli(base + ["--textgrid-path", str(tgs)])}
    infer_s = time.perf_counter() - t0
    infer_launches = lstm_fwd_kernel.launches
    for how, text in runs.items():
        rows = report_rows(text)
        if [u for u, _ in rows] != [str(n) for n in range(1, n_pairs + 1)]:
            raise AssertionError(f"infer ({how}): reports {rows}")
        for utt, got in rows:
            word = LEX_WORDS[int(utt) - 1]
            if how == "textgrid":
                want = [p for p in read_phonemes_from_textgrid(
                    str(tgs / f"{utt}.TextGrid")) if p != "sil"]
            elif how == "ipa":
                want = [CMU_TO_IPA_WIKI.get(p.upper(), p) for p in canon[word]]
            else:
                want = canon[word]
            if got != want:
                raise AssertionError(f"infer ({how}) {utt} {word}: canonical "
                                     f"{got}, the lexicon's {want}")
        rtf = [l for l in text.splitlines()
               if l.startswith(("RTF:", "init model time:", "process time:"))]
        if len(rtf) != 3:
            raise AssertionError(f"infer ({how}): RTF lines {rtf}")
        log(f"[lexicon] infer ({how}): {n_pairs} reports ok; {rtf[0]}")
    dumped = dump.read_text().splitlines()
    if [l.split()[0] for l in dumped] != [str(n)
                                          for n in range(1, n_pairs + 1)]:
        raise AssertionError(f"decode dump {dumped}")
    forwards = 3 * n_pairs   # diagnose_dir: one forward a pair
    log(f"[lexicon] infer: 3 runs in {infer_s:.2f} s; lstm_fwd launches "
        f"{infer_launches} over {forwards} model forwards ({card})")
    if infer_launches < lstm_per_pass() * forwards:
        raise AssertionError(f"{infer_launches} kernel launches for "
                             f"{forwards} forwards: a layer bypassed it")

    # (c) serve, word-only requests, --warmup and --max-batch 4
    def word_request(i, word, rid, canonical=None):
        req = {"id": rid, "wav": files["paths"][i % n_files], "word": word}
        if canonical is not None:
            req["canonical"] = canonical
        return json.dumps(req)

    lines = [word_request(i, w, i) for i, w in enumerate(LEX_WORDS)]
    lines += [word_request(i + 1, w, 100 + i)
              for i, w in enumerate(LEX_WORDS)]
    lines.append(word_request(1, "gather", "override",
                              ["g", "ae", "dh", "er"]))
    out, err = io.StringIO(), io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO("\n".join(lines) + "\n")
    lstm_fwd_kernel.launches = 0
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["serve", "--conf", str(WORK / "serve.yaml"),
                           "--checkpoint", str(WORK / "ckpt"),
                           "--cmvn", str(WORK / "cmvn.txt"),
                           "--dict-dir", dict_dir, "--ecdict-csv", ecdict,
                           "--warmup", "--max-batch", "4", "--device", "cuda",
                           "--quiet"])
    finally:
        sys.stdin = stdin
    serve_launches = lstm_fwd_kernel.launches
    if rc != 0:
        raise AssertionError(f"serve exited {rc}: {err.getvalue()}")
    resps = [json.loads(l) for l in out.getvalue().splitlines()]
    check_ok(resps, len(lines))
    translated = {"about", "gather", "vocabulary", "magazine", "through"}
    with_phonics = {"about", "gather", "through", "talked"}
    for r in resps:
        if not r["ipa"].startswith("英: /"):
            raise AssertionError(f"ipa {r['ipa']!r}")
        if bool(r["translation"]) != (r["word"] in translated):
            raise AssertionError(f"translation of {r['word']}: "
                                 f"{r['translation']!r}")
        if bool(r["phonics"]) != (r["word"] in with_phonics):
            raise AssertionError(f"phonics of {r['word']}: {r['phonics']!r}")
        want = (["g", "ae", "dh", "er"] if r["id"] == "override"
                else canon[r["word"]])
        got = [p for p in r["canonical_row"].split()[2:] if p != "I"]
        if got != want:
            raise AssertionError(f"{r['id']} {r['word']}: canonical {got}, "
                                 f"want {want}")
    batches = [r["batch"] for r in resps]
    if max(batches) > 4:
        raise AssertionError(f"a group of {max(batches)} past --max-batch 4")
    tail = err.getvalue().strip().splitlines()
    warmed = next(l for l in tail if l.startswith("warmed "))
    serve_forwards = int(tail[-1].split(" in ")[1].split()[0])
    log(f"[lexicon] serve: {len(lines)} word-only requests ok (one with a "
        f"canonical override, one word in no dictionary), groups "
        f"{sorted(set(batches))}; {warmed}; {tail[-1]}")
    log(f"[lexicon] serve: lstm_fwd launches {serve_launches} over "
        f"{serve_forwards} model forwards")
    if (serve_launches < lstm_per_pass() * serve_forwards
            or serve_forwards == 0):
        raise AssertionError(f"{serve_launches} kernel launches for "
                             f"{serve_forwards} forwards")

    # (e) numbers: word-only vs canonical-carrying latency, in turns; the
    # lexicon's host time a word; the cold start of a CMUdict-sized load
    engine = cli._build_engine(cli.build_parser().parse_args(files["args"]))
    engine.warmup()
    lat = {"word": [], "canonical": []}
    for _ in range(3):
        for i, w in enumerate(LEX_WORDS):
            for kind in ("word", "canonical"):
                line = word_request(i, w, i, None if kind == "word"
                                    else canon[w])
                t0 = time.perf_counter()
                check_ok(handle_requests(engine, [line]), 1)
                lat[kind].append(time.perf_counter() - t0)
    log(f"[lexicon] p50 batch-1 latency over {len(lat['word'])} requests, "
        f"in turns: word-only {statistics.median(lat['word']) * 1e3:.3f} ms, "
        f"canonical-carrying {statistics.median(lat['canonical']) * 1e3:.3f}"
        f" ms ({card})")
    reps = 200
    t0 = time.perf_counter()
    for _ in range(reps):
        for w in LEX_WORDS:
            engine._word_meta(w, None)
    meta_us = (time.perf_counter() - t0) / (reps * len(LEX_WORDS)) * 1e6
    log(f"[lexicon] _word_meta host time: {meta_us:.1f} us a word (mean "
        f"over {reps} x {len(LEX_WORDS)} words, the small dictionary)")
    t0 = time.perf_counter()
    big_dir, big_word = write_big_lexicon(CMUDICT_ENTRIES)
    gen_s = time.perf_counter() - t0
    big = Phonetic(big_dir)
    t0 = time.perf_counter()
    big.validate_assets()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        first = big.canonical_model_phones(big_word)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        big.canonical_model_phones(big_word)
        warm_us = (time.perf_counter() - t0) * 1e6
    if not first or len(big.cmudict_plain) != CMUDICT_ENTRIES:
        raise AssertionError(f"big dictionary: {len(big.cmudict_plain)} "
                             f"entries, {first}")
    log(f"[lexicon] cold start: the first lookup loads {CMUDICT_ENTRIES:,} "
        f"+ {len(big.cmudict_ipa):,} entries in {cold_s:.3f} s; the next "
        f"lookup {warm_us:.1f} us (files written in {gen_s:.2f} s)")
    return {"infer": infer_launches, "serve-lexicon": serve_launches}


# phase product: the front end and socket serving of `mdd_tpu`'s product
FEAT_WAVS = 64
FEAT_TOL = 2e-4    # card vs CPU features, plus each element's rounding
# bound (feature_tol): a log-mel of a band the signal barely has carries
# the DFT's float32 rounding through its power, and CMVN scales each
# dimension's rounding by 1 / std
SOCKET_CLIENTS, SOCKET_REQUESTS, UNIX_REQUESTS = 4, 16, 8
STALL_WAIT_S = 2.0  # the longest a reading client may wait on a stalled one
LOAD_SECONDS = 10.0
LOAD_CLIENTS = (1, 4, 16)


def feature_tol(wave, feat_type: str, cmvn):
    """FEAT_TOL plus the rounding bound of each feature, element by element:
    4 float32 ulps of its value and, for a log-mel or a spectrogram bin,
    one ulp of sum_n |x_n w_n| in a DFT bin's real and imaginary parts
    carried through its power (or magnitude) and log; an MFCC mixes 23
    log-mels through the DCT, which averages that term out.  Times
    CMVN's 1 / std (the spectrogram: its own 1 / std)."""
    import numpy as np

    from mdd_tpu_torch.frontend import fbank, mfcc

    eps = float(np.finfo(np.float32).eps)
    wave = np.asarray(wave, np.float64)
    if feat_type == "spectrogram":
        t = 1 + max(0, len(wave) - 400) // 160
        idx = np.clip(np.arange(t)[:, None] * 160 + np.arange(400), 0,
                      len(wave) - 1)
        frames = wave[idx] * fbank._window_function(fbank.FbankConfig())
        mag = np.abs(np.fft.rfft(frames, 512, axis=1))
        raw = np.log1p(mag)
        d = (eps * np.abs(frames).sum(axis=1, keepdims=True) * np.sqrt(2)
             / (1 + mag) + 4 * eps * raw) / max(raw.std(), 1e-8)
        return FEAT_TOL + d
    cfg = mfcc.MfccConfig() if feat_type == "mfcc" else fbank.FbankConfig()
    fb_cfg = cfg.fbank_config() if feat_type == "mfcc" else cfg
    n_t = fbank.num_frames(len(wave), fb_cfg)
    idx = (np.arange(n_t)[:, None] * fb_cfg.frame_shift
           + np.arange(fb_cfg.frame_length))
    frames = wave[idx] - wave[idx].mean(axis=1, keepdims=True)
    log_energy = np.log(np.maximum((frames ** 2).sum(axis=1), eps))
    frames = np.concatenate([frames[:, :1] * (1 - fb_cfg.preemphasis),
                             frames[:, 1:] - fb_cfg.preemphasis
                             * frames[:, :-1]], axis=1)
    frames = frames * fbank._window_function(fb_cfg)
    spec = np.fft.rfft(frames, fb_cfg.padded_length,
                       axis=1)[:, :fb_cfg.padded_length // 2]
    bank = fbank._dft_and_mel_matrices(fb_cfg)[1].astype(np.float64)
    log_mel = np.log(np.maximum(np.abs(spec) ** 2 @ bank, eps))
    if feat_type == "mfcc":
        dct, lifter = mfcc._dct_and_lifter(cfg.num_mel_bins, cfg.num_ceps,
                                           cfg.cepstral_lifter)
        d = 4 * eps * np.abs(log_mel @ dct * lifter)
    else:
        d_x = eps * np.abs(frames).sum(axis=1, keepdims=True)
        d_power = 2 * np.sqrt(2) * np.abs(spec) * d_x + 2 * d_x ** 2
        d = np.concatenate([4 * eps * np.abs(log_energy)[:, None],
                            d_power @ bank / np.exp(log_mel)
                            + 4 * eps * np.abs(log_mel)], axis=1)
    return FEAT_TOL + d / np.sqrt(cmvn.var)


def write_feat_wavs() -> tuple:
    """FEAT_WAVS seeded wavs of 0.6-3.2 s and their wav.scp under
    WORK/feat -> (wav.scp, the paths)."""
    from mdd_tpu_torch.tools.serve_loadtest import write_wavs

    d = WORK / "feat"
    d.mkdir()
    paths = write_wavs(str(d), FEAT_WAVS, SEED + 7)
    scp = d / "wav.scp"
    scp.write_text("".join(f"f{i:03d} {p}\n" for i, p in enumerate(paths)))
    return str(scp), paths


def product_feat(torch, scp: str, paths: list, card: str) -> None:
    """(a) `feat` for the three types on the card and on the CPU; the
    features agree, the CMVN files are written; bulk_load of the fbank ark
    natively and by the Python pass, bit for bit, timed."""
    import numpy as np

    from mdd_tpu_torch.frontend import kaldi_io
    from mdd_tpu_torch.frontend.cmvn import parse_kaldi_cmvn_text
    from mdd_tpu_torch.frontend.wav import read_audio

    waves = {f"f{i:03d}": read_audio(p)[0] for i, p in enumerate(paths)}
    audio_s = sum(len(w) for w in waves.values()) / 16000.0
    for feat_type in ("fbank", "mfcc", "spectrogram"):
        out, secs = {}, {}
        for device in ("cuda", "cpu"):
            out[device] = WORK / "feat" / f"{feat_type}-{device}"
            t0 = time.perf_counter()
            run_cli(["feat", "--wav-scp", scp, "--out-dir",
                     str(out[device]), "--feat-type", feat_type,
                     "--device", device])
            if device == "cuda":
                torch.cuda.synchronize()
            secs[device] = time.perf_counter() - t0
        cmvn_file = out["cuda"] / f"global_{feat_type}_cmvn.txt"
        if (feat_type != "spectrogram") != cmvn_file.exists():
            raise AssertionError(f"feat {feat_type}: CMVN file "
                                 f"{'missing' if not cmvn_file.exists() else 'written'}")
        cmvn = (parse_kaldi_cmvn_text(str(cmvn_file))
                if feat_type != "spectrogram" else None)
        card_scp = kaldi_io.read_scp(str(out["cuda"] / f"{feat_type}.scp"))
        cpu_scp = kaldi_io.read_scp(str(out["cpu"] / f"{feat_type}.scp"))
        if list(card_scp) != list(cpu_scp) or len(card_scp) != FEAT_WAVS:
            raise AssertionError(f"feat {feat_type}: utterances differ")
        worst, over = 0.0, 0
        for utt in card_scp:
            a = kaldi_io.load_mat(card_scp[utt])
            b = kaldi_io.load_mat(cpu_scp[utt])
            if a.shape != b.shape or not np.isfinite(a).all():
                raise AssertionError(f"feat {feat_type} {utt}: {a.shape} "
                                     f"vs {b.shape}")
            err = np.abs(a.astype(np.float64) - b)
            worst = max(worst, float(err.max()))
            over += int((err > FEAT_TOL).sum())
            if (err > feature_tol(waves[utt], feat_type, cmvn)).any():
                raise AssertionError(f"feat {feat_type} {utt}: card vs CPU "
                                     f"{err.max():.3g} past its tolerance")
        log(f"[product] feat {feat_type}: {FEAT_WAVS} wavs ({audio_s:.1f} s "
            f"of audio), card {secs['cuda']:.3f} s, CPU {secs['cpu']:.3f} s; "
            f"card vs CPU max |diff| {worst:.3g}, {over} elements past "
            f"{FEAT_TOL:g} (within their rounding bound) ({card})")
    rxs = list(kaldi_io.read_scp(
        str(WORK / "feat" / "fbank-cuda" / "fbank.scp")).values())
    native = kaldi_io.bulk_load(rxs)
    plain = kaldi_io.bulk_load_python(rxs)
    if not all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(native, plain)):
        raise AssertionError("bulk_load: native and Python reads differ")
    times = {"native": [], "python": []}
    for _ in range(5):   # in turns, the file in the page cache
        for name, fn in (("native", kaldi_io.bulk_load),
                         ("python", kaldi_io.bulk_load_python)):
            t0 = time.perf_counter()
            fn(rxs)
            times[name].append(time.perf_counter() - t0)
    nbytes = sum(m.nbytes for m in native)
    log(f"[product] bulk_load of the fbank ark ({len(rxs)} matrices, "
        f"{nbytes / 2**20:.2f} MiB), median of 5 in turns: native "
        f"{statistics.median(times['native']) * 1e3:.3f} ms, Python pass "
        f"{statistics.median(times['python']) * 1e3:.3f} ms; equal bit for "
        f"bit (the card machine's host)")


def product_infer(torch, files, paths: list, card: str) -> int:
    """(b) `infer` with the default --denoise over phase lexicon's pairs;
    the denoiser's SNR gain and its host time; -> lstm_fwd launches."""
    import numpy as np

    from mdd_tpu_torch import native
    from mdd_tpu_torch.frontend.wav import read_audio
    from mdd_tpu_torch.ops.lstm_cuda import lstm_fwd_kernel

    pairs = WORK / "pairs"
    n_pairs = len(LEX_WORDS)
    lstm_fwd_kernel.launches = 0
    text = run_cli(["infer", "--wav-transcript-path", str(pairs), "--conf",
                    str(WORK / "serve.yaml"), "--checkpoint",
                    str(WORK / "ckpt"), "--cmvn", str(WORK / "cmvn.txt"),
                    "--dict-dir", files["dict_dir"], "--ecdict-csv",
                    files["ecdict"], "--device", "cuda"])
    launches = lstm_fwd_kernel.launches
    rows = report_rows(text)
    if [u for u, _ in rows] != [str(n) for n in range(1, n_pairs + 1)]:
        raise AssertionError(f"infer --denoise: reports {rows}")
    rtf = [l for l in text.splitlines()
           if l.startswith(("RTF:", "init model time:", "process time:"))]
    if len(rtf) != 3:
        raise AssertionError(f"infer --denoise: RTF lines {rtf}")
    if launches < lstm_per_pass() * n_pairs:
        raise AssertionError(f"infer --denoise: {launches} lstm_fwd launches "
                             f"for {n_pairs} forwards")
    log(f"[product] infer --denoise: {n_pairs} reports ok; {rtf[0]}; "
        f"{rtf[1]}")
    log(f"[product] infer --denoise: lstm_fwd launches {launches} over "
        f"{n_pairs} model forwards")
    # the denoiser on a seeded noisy tone: SNR up by at least 3 dB
    rng = np.random.default_rng(SEED)
    t = np.arange(3 * 16000) / 16000.0
    clean = np.zeros_like(t, dtype=np.float32)
    for f0, start in [(220.0, 0.5), (440.0, 1.2), (330.0, 2.0)]:
        seg = (t >= start) & (t < start + 0.4)
        clean[seg] = 8000 * np.sin(2 * np.pi * f0 * t[seg]) * np.hanning(
            seg.sum())
    noisy = clean + rng.standard_normal(t.size).astype(np.float32) * 500

    def snr(y):
        return 10 * np.log10(np.sum(clean ** 2) / np.sum((y - clean) ** 2))

    before, after = snr(noisy), snr(native.spectral_denoise(noisy))
    if not after > before + 3.0:
        raise AssertionError(f"denoise: SNR {before:.2f} -> {after:.2f} dB")
    # its host time over phase product's wavs
    waves = [read_audio(p)[0] for p in paths]
    audio_s = sum(len(w) for w in waves) / 16000.0
    passes = []
    for _ in range(3):
        t0 = time.perf_counter()
        for w in waves:
            native.spectral_denoise(w)
        passes.append(time.perf_counter() - t0)
    per_s = statistics.median(passes) * 1e3 / audio_s
    log(f"[product] denoise: SNR {before:.2f} -> {after:.2f} dB on a seeded "
        f"noisy tone; host time {per_s:.3f} ms per audio-second (median of 3 "
        f"passes over {len(waves)} wavs, {audio_s:.1f} s; a 0.6 / 3.2 s wav "
        f"{0.6 * per_s:.2f} / {3.2 * per_s:.2f} ms; the card machine's host)")
    return launches


def socket_client(address, lines, timeout: float = 60.0) -> list:
    """One client: send every line, then read one answer each."""
    import socket

    if isinstance(address, int):
        s = socket.create_connection(("127.0.0.1", address), timeout=timeout)
    else:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(address)
    with s:
        s.sendall(("\n".join(lines) + "\n").encode())
        f = s.makefile("r", encoding="utf-8")
        return [json.loads(f.readline()) for _ in lines]


def product_socket(torch, files, card: str) -> int:
    """(c) `serve --socket 127.0.0.1:0 --max-batch 16 --warmup` and `serve
    --socket PATH` in threads: 4 TCP clients and a unix one at once, every
    answer ok and equal to the request's solo answer, no group past 16; a
    non-loopback bind refused; a client that stops reading; -> lstm_fwd
    launches."""
    import socket
    import threading

    import mdd_tpu_torch.serve as serve_mod
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.ops.lstm_cuda import lstm_fwd_kernel

    n_files = len(files["paths"])

    def line(tag, k):
        return json.dumps({"id": f"{tag}{k}", "wav": files["paths"][k % n_files],
                           "word": LEX_WORDS[k % len(LEX_WORDS)]})

    servers, rcs = [], []
    base = serve_mod.SocketServer

    class Recorded(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            servers.append(self)

    unix_path = str(WORK / "product.sock")
    argvs = [files["args"] + ["--socket", "127.0.0.1:0", "--max-batch", "16",
                              "--warmup", "--quiet"],
             files["args"] + ["--socket", unix_path, "--max-batch", "16",
                              "--quiet"]]
    err = io.StringIO()
    lstm_fwd_kernel.launches = 0
    serve_mod.SocketServer = Recorded
    threads = [threading.Thread(target=lambda a=a: rcs.append(cli.main(a)),
                                daemon=True) for a in argvs]
    try:
        with contextlib.redirect_stderr(err):
            for t in threads:
                t.start()
            deadline = time.monotonic() + 300
            while len(servers) < 2 and time.monotonic() < deadline:
                time.sleep(0.05)
            if len(servers) < 2:
                raise AssertionError(f"socket servers did not start: "
                                     f"{err.getvalue()[-2000:]}")
            tcp = next(s for s in servers if s.port is not None)
            got = {}

            def client(name, address, lines):
                got[name] = socket_client(address, lines)

            work = {f"tcp{c}": (tcp.port, [line(f"t{c}-", k) for k in
                                           range(SOCKET_REQUESTS)])
                    for c in range(SOCKET_CLIENTS)}
            work["unix"] = (unix_path, [line("u-", k)
                                        for k in range(UNIX_REQUESTS)])
            t0 = time.perf_counter()
            clients = [threading.Thread(target=client, args=(n, *w))
                       for n, w in work.items()]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=300)
            wall = time.perf_counter() - t0
            if sorted(got) != sorted(work):
                raise AssertionError(f"clients answered: {sorted(got)}")
            # a client that stops reading, with the bounds of the test
            # suite: its outbox of 4 overflows and it is dropped, while
            # another client's answers keep coming
            tcp.outbox_max, tcp.sndbuf = 4, 4096
            stalled = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            stalled.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
            stalled.settimeout(60)
            stalled.connect(("127.0.0.1", tcp.port))
            flood = "".join(json.dumps({"id": k, "wav": "/nonexistent/"
                                        + "x" * 2000, "word": "about"}) + "\n"
                            for k in range(2000)).encode()

            def send_flood():
                with contextlib.suppress(OSError):
                    stalled.sendall(flood)

            sender = threading.Thread(target=send_flood, daemon=True)
            sender.start()
            waits = []
            for k in range(4):
                t1 = time.perf_counter()
                (resp,) = socket_client(tcp.port, [line("g-", k)])
                waits.append(time.perf_counter() - t1)
                if resp["status"] != "ok":
                    raise AssertionError(f"beside a stalled client: {resp}")
            deadline = time.monotonic() + 60
            while tcp.n_dropped == 0 and time.monotonic() < deadline:
                time.sleep(0.05)
            stalled.close()
            sender.join(timeout=60)
            for s in servers:
                s.shutdown()
            for t in threads:
                t.join(timeout=120)
    finally:
        serve_mod.SocketServer = base
    launches = lstm_fwd_kernel.launches
    if any(t.is_alive() for t in threads) or rcs != [0, 0]:
        raise AssertionError(f"socket servers: exit codes {rcs}; "
                             f"{err.getvalue()[-2000:]}")
    if tcp.n_dropped != 1:
        raise AssertionError(f"{tcp.n_dropped} connections dropped, not the "
                             "stalled one")
    if max(waits) > STALL_WAIT_S:
        raise AssertionError(f"answers beside a stalled client took {waits}")
    if os.path.exists(unix_path):
        raise AssertionError("the unix socket path was not unlinked")
    text = err.getvalue()
    if "ready on port " not in text or f"ready on {unix_path}" not in text:
        raise AssertionError(f"ready lines missing: {text[-2000:]}")
    forwards = sum(int(l.split(" in ")[1].split()[0])
                   for l in text.splitlines() if l.startswith("served "))
    if launches < lstm_per_pass() * forwards or forwards == 0:
        raise AssertionError(f"{launches} lstm_fwd launches for {forwards} "
                             "forwards")
    # every answer: ok, in order, groups of at most 16, equal to its solo
    # answer on the fields that the grouping must not move
    solo_engine = cli._build_engine(cli.build_parser().parse_args(
        files["args"]))
    batches = []
    for name, (_, lines) in work.items():
        for req, resp in zip(lines, got[name]):
            (solo,) = serve_mod.handle_requests(solo_engine, [req])
            if resp["status"] != "ok" or resp["id"] != json.loads(req)["id"]:
                raise AssertionError(f"{name}: {resp}")
            for k in ("decoded_row", "canonical_row", "insertion_faults",
                      "substitution_faults", "deletion_faults", "score"):
                if resp[k] != solo[k]:
                    raise AssertionError(f"{name} {resp['id']}: {k} "
                                         f"{resp[k]!r}, solo {solo[k]!r}")
            batches.append(resp["batch"])
    if max(batches) > 16:
        raise AssertionError(f"a group of {max(batches)} past --max-batch 16")
    try:
        base(solo_engine, "0.0.0.0:0")
        raise AssertionError("a bind to 0.0.0.0 was taken")
    except ValueError:
        pass
    n_req = SOCKET_CLIENTS * SOCKET_REQUESTS + UNIX_REQUESTS
    log(f"[product] serve --socket: {SOCKET_CLIENTS} TCP clients x "
        f"{SOCKET_REQUESTS} and a unix client x {UNIX_REQUESTS}, {n_req} "
        f"answers ok in {wall:.3f} s, each equal to its solo answer; groups "
        f"{sorted(set(batches))} (at most 16); 0.0.0.0 refused ({card})")
    log(f"[product] serve --socket: beside a client that stopped reading "
        f"(dropped: {tcp.n_dropped}), 4 answers in "
        f"{max(waits) * 1e3:.1f} ms at most; the unix path unlinked")
    log(f"[product] serve --socket: lstm_fwd launches {launches} over "
        f"{forwards} model forwards (warmup included)")
    return launches


def product_loadtest(files, paths: list, card: str) -> None:
    """(d), not gating: the port's serve_loadtest at 1, 4 and 16 clients,
    denoise on and off."""
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.tools.serve_loadtest import run_loadtest

    requests = [(p, LEX_WORDS[i % len(LEX_WORDS)])
                for i, p in enumerate(paths)]
    for denoise in ("--denoise", "--no-denoise"):
        engine = cli._build_engine(cli.build_parser().parse_args(
            files["args"] + [denoise]))
        engine.warmup()
        for clients in LOAD_CLIENTS:
            out = run_loadtest(engine, requests, clients, LOAD_SECONDS)
            log(f"[product] load {denoise} clients={clients}: "
                + json.dumps({k: out[k] for k in (
                    "requests_ok", "errors", "requests_per_s", "p50_ms",
                    "p90_ms", "p99_ms", "max_ms", "forwards", "seconds")})
                + f" ({card})")
            if out["errors"]:
                log(f"[product]   errors: {out['sample_errors']}")


def phase_product(torch, files, card: str) -> dict:
    """The product front end on phase serve's files: feat, infer --denoise,
    serve --socket, then the load test; -> lstm_fwd launches by path."""
    t0 = time.perf_counter()
    scp, paths = write_feat_wavs()
    product_feat(torch, scp, paths, card)
    launches = {"infer-denoise": product_infer(torch, files, paths, card),
                "serve-socket": product_socket(torch, files, card)}
    product_loadtest(files, paths, card)
    log(f"[product] phase in {time.perf_counter() - t0:.1f} s")
    return launches


def phase_profile(torch, engine, files, card: str) -> None:
    """Where a batch-1 request's time goes: device busy share of the wall
    clock and the kernels that take the most device time (torch.profiler
    over one request per wav, after the serve phase warmed everything)."""
    from torch.profiler import ProfilerActivity, profile

    from mdd_tpu_torch.serve import handle_requests

    n = len(files["paths"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            handle_requests(engine, [request(files, i)])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, "profile", f"{n} batch-1 requests", card)


#: the device names of the package's own kernels (report_profile lists them)
PACKAGE_KERNELS = ("lstm_", "dropout_kernel", "greedy_wer_kernel",
                   "ctc_beam_kernel", "ctc_alpha_kernel",
                   "ctc_beta_grad_kernel", "scan_fwd_kernel",
                   "scan_chain_kernel", "scan_z_kernel", "scan_dw")


def device_ops(prof) -> list:
    """A profile's device operations, averaged by name: the program's
    spans (mdd_tpu_torch/utils/trace.py, on while a profiler records)
    also show on the device's timeline as user annotations, and are no
    operation of the device's."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def report_profile(prof, wall_us: float, tag: str, what: str,
                   card: str) -> int:
    """Device busy share of the wall clock and the top device ops; -> the
    count of device ops."""
    events = device_ops(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time")
    log(f"[{tag}] {what}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{sum(e.count for e in events)} device ops ({card})")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the top ten, and below them every kernel of the package's own
    for e in ranked[:10] + [e for e in ranked[10:]
                            if any(n in e.key for n in PACKAGE_KERNELS)]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    return sum(e.count for e in events)


def host_syncs(prof) -> dict:
    """The CUDA runtime calls of a profile that make the host wait for the
    device, by name (the window's own closing synchronize included)."""
    return {e.key: e.count for e in prof.key_averages()
            if "Synchronize" in e.key}


def write_corpus(split: str, n: int, seed: int) -> tuple:
    """n utterances of 16-40 phones between two "sil" of the 41-unit
    inventory, each phone a fixed band template over the 81 fbank bins for
    6-15 frames plus noise (T' = 47-110 after skip and conv), the labels
    the canonical phones with 15% substituted; -> (scp, lab, trans)."""
    import numpy as np

    from mdd_tpu_torch.frontend.kaldi_io import ArkScpWriter

    rng = np.random.default_rng(seed)
    templates = {}
    for k, unit in enumerate(UNITS):
        t_rng = np.random.default_rng(1000 + k)
        base = np.full(81, -1.0, np.float32)
        for c in t_rng.choice(np.arange(4, 77), size=3, replace=False):
            w = int(t_rng.integers(2, 5))
            base[c - w:c + w] = 2.0 + t_rng.uniform(0.0, 1.0)
        templates[unit] = base
    content = [u for u in UNITS if u not in ("sil", "err")]
    root = WORK / "corpus"
    root.mkdir(parents=True, exist_ok=True)
    scp, lab, trn = (str(root / f"{split}.{x}")
                     for x in ("scp", "phn_text", "trans"))
    with ArkScpWriter(str(root / f"{split}.ark"), scp) as w, \
            open(lab, "w") as fl, open(trn, "w") as ft:
        for i in range(n):
            canon = (["sil"] + [content[k] for k in rng.integers(
                0, len(content), rng.integers(16, 41))] + ["sil"])
            actual = [content[rng.integers(len(content))]
                      if 0 < j < len(canon) - 1 and rng.random() < 0.15
                      else p for j, p in enumerate(canon)]
            feats = np.concatenate([np.repeat(
                templates[p][None], rng.integers(6, 16), axis=0)
                for p in actual])
            feats += 0.35 * rng.standard_normal(feats.shape).astype(
                np.float32)
            w.write(f"{split}_{i:04d}", feats)
            fl.write(f"{split}_{i:04d} {' '.join(actual)}\n")
            ft.write(f"{split}_{i:04d} {' '.join(canon)}\n")
    return scp, lab, trn


def write_train_yaml(train, dev, epochs: int,
                     compute_dtype: str = "float32", **overrides) -> str:
    """The flagship recipe (conf/ctc_config.yaml's, in float32 unless
    said) on the streaming loader, over the seeded corpus, on one card
    (`data_parallel: 1`, where the recipe says 0, every card); `overrides`
    replace fields (another experiment, corpus or loader)."""
    fields = {
        "exp_name": "smoke_train", "checkpoint_dir": str(WORK / "ckpt"),
        "seed": 1234, "vocab_file": str(WORK / "units"),
        "train_scp_path": train[0], "train_lab_path": train[1],
        "train_trans_path": train[2], "valid_scp_path": dev[0],
        "valid_lab_path": dev[1], "valid_trans_path": dev[2],
        "left_ctx": 0, "right_ctx": 2, "n_skip_frame": 2, "n_downsample": 2,
        "feature_dim": 81, "rnn_hidden_size": H, "rnn_layers": 4,
        "drop_out": 0.2, "channel": "[(1, 32), (32, 32)]",
        "kernel_size": "[(3, 3), (3, 3)]", "stride": "[(1, 2), (2, 2)]",
        "padding": "[(1, 1), (1, 1)]", "use_text_attention": True,
        "use_pallas_lstm": True, "device_frontend": True,
        "wire_dtype": "bfloat16", "compute_dtype": compute_dtype,
        "device_cache": False, "init_lr": 0.001, "num_epoches": epochs,
        "end_adjust_acc": 2.0, "lr_decay": 0.5, "batch_size": BATCH,
        "weight_decay": 0.0005, "verbose_step": 1, "max_adjust_times": 8,
        "plateau_patience": 10, "augment_mode": 2, "mutation_prob": 0.1,
        "num_workers": 4, "data_parallel": 1}
    fields.update(overrides)
    path = WORK / f"{fields['exp_name']}{epochs}_{compute_dtype}.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n"
                            for k, v in fields.items()))
    return str(path)


def phase_model_grad(torch, cfg, state, corpus) -> None:
    """One Trainer step of the full-width model at B=8, dropout 0, with
    the kernels and with the plain LSTM, from the same weights and batch."""
    from mdd_tpu_torch.data.dataset import BucketedLoader, SpeechDataset
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.train.loop import Trainer

    ds = SpeechDataset(Vocab.from_units_file(str(WORK / "units")), *corpus,
                       device_frontend=True)
    batch = next(iter(BucketedLoader(ds, 8)))
    out = {}
    for name, use in (("kernel", True), ("plain", False)):
        tr = Trainer(dataclasses.replace(cfg, use_pallas_lstm=use,
                                         dropout=0.0),
                     device="cuda", device_frontend=True)
        tr.model.load_state_dict(state, strict=True)
        acc = tr.train_step(tr.batch_arrays(batch),
                            torch.zeros(4, device="cuda"))
        out[name] = (acc.cpu(),
                     {n: p.grad for n, p in tr.model.named_parameters()},
                     dict(tr.model.named_buffers()))
    (acc_k, g_k, b_k), (acc_p, g_p, b_p) = out["kernel"], out["plain"]
    loss_err = abs(acc_k[0] - acc_p[0]).item() / abs(acc_p[0]).item()
    top = max(g.abs().max().item() for g in g_p.values())
    noise = ZERO_ULPS * torch.finfo(torch.float32).eps * top
    zero = {n for n, g in g_p.items() if g.abs().max().item() <= noise}
    zero_max = max((max(g_k[n].abs().max().item(), g_p[n].abs().max().item())
                    for n in zero), default=0.0) / top
    grad_err = {n: rel_err(g_k[n], g_p[n]) for n in g_p if n not in zero}
    stat_err = max(rel_err(b_k[n], b_p[n]) for n in b_p)
    worst = max(grad_err, key=grad_err.get)
    log(f"[model-grad] B=8 T'={batch.inputs.shape[1] // 4}: loss "
        f"{acc_k[0].item():.4f} vs {acc_p[0].item():.4f} (rel {loss_err:.2e}"
        f"), WER counts {acc_k[1:3].tolist()} vs {acc_p[1:3].tolist()}; "
        f"worst gradient {worst} rel err {grad_err[worst]:.3e} over "
        f"{len(grad_err)} tensors; 0 up to rounding in the plain run: "
        f"{sorted(zero)}, at most {zero_max:.2e} of the largest gradient in "
        f"either run (limit {ZERO_ULPS * torch.finfo(torch.float32).eps:.2e})"
        f"; BN statistics rel err {stat_err:.3e} (tol {GRAD_TOL})")
    if not (loss_err <= 1e-5 and grad_err[worst] <= GRAD_TOL
            and zero_max * top <= noise
            and stat_err <= GRAD_TOL and all(torch.isfinite(
                g).all() for g in g_k.values())):
        raise AssertionError("kernel and plain-LSTM train steps disagree")


def run_cli(args) -> str:
    """`python -m mdd_tpu_torch <args>` in this process; -> its stdout."""
    from mdd_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(args)
    if rc != 0:
        raise AssertionError(f"{args} exited {rc}")
    return out.getvalue()


def phase_train(torch, train, dev) -> tuple:
    """The training path; -> (lstm_fwd launches, lstm_bwd launches, the
    epoch-2 YAML, the first step's loss)."""
    from mdd_tpu_torch.ops.lstm_cuda import lstm_bwd_kernel, lstm_fwd_kernel

    confs = [write_train_yaml(train, dev, e) for e in (1, 2)]
    lstm_fwd_kernel.launches = lstm_bwd_kernel.launches = 0
    zero_path_launches()
    t0 = time.perf_counter()
    out = run_cli(["train", "--conf", confs[0], "--device", "cuda"])
    out += run_cli(["train", "--conf", confs[1], "--device", "cuda",
                    "--resume"])
    wall = time.perf_counter() - t0
    fwd, bwd = lstm_fwd_kernel.launches, lstm_bwd_kernel.launches
    new = record_path_launches("train")
    for line in out.splitlines():
        if "done" in line or "resumed" in line or "best dev" in line:
            log(f"[train]   {line}")
    losses = [float(v) for v in
              re.findall(r"total_loss(?::| =) (\S+?),", out)]
    first = float(re.search(r"Epoch = 1, step = 1, total_loss = (\S+?),",
                            out).group(1))
    ep2 = float(re.search(r"Epoch 2 Train done, total_loss: (\S+?),",
                          out).group(1))
    steps = -(-TRAIN_UTTS // BATCH) * 2
    forwards = steps + -(-DEV_UTTS // BATCH) * 2
    ckpt = WORK / "ckpt" / "smoke_train"
    log(f"[train] 2 epochs of {TRAIN_UTTS} utterances at B={BATCH} in "
        f"{wall:.1f} s (both runs' set-up included); "
        f"first step loss {first:.4f}, epoch-2 train loss {ep2:.4f}; "
        f"lstm_fwd launches {fwd} over {forwards} forwards, lstm_bwd "
        f"launches {bwd} over {steps} train steps; greedy_wer launches "
        f"{new['greedy_wer']}, ctc_beam {new['ctc_beam']}")
    if not all(math.isfinite(v) for v in losses) or len(losses) < steps:
        raise AssertionError(f"losses not finite or missing: {losses}")
    if not ep2 < first:
        raise AssertionError(f"epoch-2 loss {ep2} is not below the first "
                             f"step's {first}")
    for name in ("best.pt", "best.meta.json", "latest.pt", "latest.opt.pt"):
        if not (ckpt / name).exists():
            raise AssertionError(f"{name} was not written")
    if bwd != lstm_per_pass() * steps or fwd < lstm_per_pass() * forwards:
        raise AssertionError(f"{fwd} forward / {bwd} backward launches for "
                             f"{forwards} forwards / {steps} train steps: a "
                             "layer bypassed the kernels")
    # one WER and one CTC forward a train or validation step, each a
    # forward of lstm_per_pass() layers; one CTC backward a train step
    if (lstm_per_pass() * new["greedy_wer"] != fwd or new["ctc_beam"]
            or new["ctc_alpha"] != new["greedy_wer"]
            or new["ctc_beta_grad"] != steps):
        raise AssertionError(f"{new} for {fwd // lstm_per_pass()} train and "
                             f"validation steps, {steps} train steps: the "
                             "WER or the loss bypassed its kernel")
    return fwd, bwd, confs[1], first


def phase_step_time(torch, conf: str, card: str) -> None:
    """Train steps at B=64 on the corpus, each timed to a synchronize, then
    torch.profiler over 3 more: device busy share and top device ops."""
    from torch.profiler import ProfilerActivity, profile

    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.dataset import pad_batch_to
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.utils.config import load_config

    cfg = load_config(conf)
    vocab = Vocab.from_units_file(cfg.vocab_file)
    trainer = cli.build_trainer(cfg, vocab, "cuda")
    trainer.restore(cfg.checkpoint_dir, cfg.exp_name, "latest")
    loader = cli._build_loader(cfg, vocab, cfg.train_scp_path,
                               cfg.train_lab_path, cfg.train_trans_path,
                               train=True)
    batches = [pad_batch_to(b, BATCH) for b in loader]
    acc = torch.zeros(4, device="cuda")
    secs, audio = [], []
    for padded, valid in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = trainer.train_step(trainer.batch_arrays(padded, valid), acc)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        raw = padded.input_fracs[valid] * padded.inputs.shape[1]
        audio.append(float(raw.round().sum()) * 0.01)      # 10 ms frames
    med = statistics.median(secs)
    log(f"[train] step time at B={BATCH}, T' {batches[0][0].inputs.shape[1] // 4}"
        f"-{batches[-1][0].inputs.shape[1] // 4}: median {med * 1e3:.2f} ms "
        f"over {len(secs)} steps (min {min(secs) * 1e3:.2f}, max "
        f"{max(secs) * 1e3:.2f}); {sum(audio) / sum(secs):.1f} audio "
        f"seconds per second ({card})")
    # the step's WER on its kernel against the plain loop, in turns
    from mdd_tpu_torch.ops.wer import greedy_wer_counts
    from mdd_tpu_torch.train import loop

    kernel_wer = loop.greedy_wer
    medians = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        loop.greedy_wer = (kernel_wer if which == "kernel"
                           else greedy_wer_counts)
        try:
            turn = []
            for padded, valid in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                acc = trainer.train_step(trainer.batch_arrays(padded, valid),
                                         acc)
                torch.cuda.synchronize()
                turn.append(time.perf_counter() - t0)
        finally:
            loop.greedy_wer = kernel_wer
        medians[which].append(round(statistics.median(turn) * 1e3, 2))
    log(f"[train] step median at B={BATCH}, the WER on its kernel "
        f"{medians['kernel']} ms, on the plain loop {medians['plain']} ms "
        f"(in turns: kernel, plain, plain, kernel; {len(batches)} steps "
        f"each) ({card})")
    # the text BiLSTM on the LSTM kernels and the loss on the CTC kernels,
    # each against what it replaced (the plain loop, F.ctc_loss), in turns
    from mdd_tpu_torch.ops.lstm import bilstm
    from mdd_tpu_torch.ops.lstm_cuda import bilstm_cuda

    text = trainer.model.text.lstm
    kernel_ctc = loop.ctc_loss
    if text.rnn is not bilstm_cuda:
        raise AssertionError("the float32 text BiLSTM is not on the kernels")
    variants = {"kernels": (bilstm_cuda, kernel_ctc),
                "text loop": (bilstm, kernel_ctc),
                "F.ctc_loss": (bilstm_cuda, library_ctc_loss),
                "before": (bilstm, library_ctc_loss)}

    def steps(which, batch_list, acc):
        text.rnn, loop.ctc_loss = variants[which]
        try:
            turn = []
            for padded, valid in batch_list:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                acc = trainer.train_step(trainer.batch_arrays(padded, valid),
                                         acc)
                torch.cuda.synchronize()
                turn.append(time.perf_counter() - t0)
        finally:
            text.rnn, loop.ctc_loss = variants["kernels"]
        return turn, acc

    medians = {k: [] for k in variants}
    for which in list(variants) + list(variants)[::-1]:
        turn, acc = steps(which, batches, acc)
        medians[which].append(round(statistics.median(turn) * 1e3, 2))
    log(f"[train] step median at B={BATCH} (ms, in turns "
        f"{list(variants)} and back; {len(batches)} steps each): "
        + "; ".join(f"{k} {v}" for k, v in medians.items())
        + f" (text BiLSTM / loss: kernels / kernels, plain loop / kernels, "
        f"kernels / F.ctc_loss, plain loop / F.ctc_loss) ({card})")
    for which in ("kernels", "before"):
        text.rnn, loop.ctc_loss = variants[which]
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for padded, valid in batches[:3]:
                    acc = trainer.train_step(
                        trainer.batch_arrays(padded, valid), acc)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        finally:
            text.rnn, loop.ctc_loss = variants["kernels"]
        ops = report_profile(prof, wall_us, "profile-train",
                             f"3 train steps at B={BATCH}, {which}", card)
        syncs = host_syncs(prof)
        log(f"[profile-train] {which}: {ops / 3:.1f} device ops a step, "
            f"{(sum(syncs.values()) - 1) / 3:.2f} host syncs a step "
            f"besides the window's closing one {syncs} ({card})")



STRICT_LINE = ("compute_dtype float32 on cuda: cuBLAS allow_tf32=False, "
               "cuDNN allow_tf32=False")
STRICT_TIMEOUT_S = 300


def phase_train_strict(train, dev, first_in_process: float,
                       card: str) -> None:
    """`python -m mdd_tpu_torch train` as a fresh process (nothing of this
    script has run in it) for one epoch of the training corpus: the
    Trainer's first line must state both TF32 flags off."""
    conf = write_train_yaml(train, dev, 1, exp_name="strict_train")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mdd_tpu_torch", "train", "--conf", conf,
         "--device", "cuda"], cwd=ROOT, capture_output=True, text=True,
        timeout=STRICT_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[train-strict] train exited "
                             f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    flags = [line for line in proc.stdout.splitlines()
             if line.startswith("compute_dtype ")]
    first = float(re.search(r"Epoch = 1, step = 1, total_loss = (\S+?),",
                            proc.stdout).group(1))
    log(f"[train-strict] a fresh `train` process, 1 epoch in {wall:.1f} s "
        f"(start-up included): {flags}; first step loss {first:.6f} vs "
        f"phase train's in-process {first_in_process:.6f} (difference "
        f"{abs(first - first_in_process):.3e}, not gating) ({card})")
    if flags != [STRICT_LINE]:
        raise AssertionError(f"[train-strict] the trainer printed {flags}, "
                             f"not [{STRICT_LINE!r}]: TF32 is on")


PLATEAU_EPOCHS, PLATEAU_KILL = 6, 3
# what the plateau machine is fed, by epoch: a dev loss that rises every
# epoch, so only epoch 1 takes a restore point and each halving (epochs 2,
# 4 and 6: patience 2 in a band wider than any loss) restores it; a dev
# acc that peaks at epoch 2, so `best` is a state from before the kill.
# The corpus's real dev loss falls every epoch, and each halving would
# then restore the snapshot its own epoch had just taken
PLATEAU_SEEN_LOSS = {e: 100.0 + e for e in range(1, PLATEAU_EPOCHS + 2)}
PLATEAU_SEEN_ACC = {1: 0.1, 2: 0.3, 3: 0.2, 4: 0.25, 5: 0.2, 6: 0.1, 7: 0.1}
PLATEAU_DEV_RTOL = 1e-3   # printed beside the two runs' dev losses, not
# gating: cuDNN's convolution backward is not bit-deterministic


def phase_resume_plateau(torch, train, dev, card: str) -> dict:
    """`train` through the CLI at full width on the kernels, dropout 0, a
    halving every second epoch, `latest` every epoch: 6 epochs in one run
    against 3 and `--resume` to 6; then, its snapshot file deleted as if
    written before it existed, `--resume` to 7; -> the launches of the
    four runs by kernel."""
    from mdd_tpu_torch.ops.lstm_cuda import lstm_bwd_kernel, lstm_fwd_kernel
    from mdd_tpu_torch.train import loop
    from mdd_tpu_torch.train.checkpoint import load_snapshots
    from mdd_tpu_torch.train.plateau import PlateauScheduler

    fields = dict(drop_out=0.0, end_adjust_acc=1000.0, plateau_patience=2,
                  checkpoint_every=1)
    whole = write_train_yaml(train, dev, PLATEAU_EPOCHS,
                             exp_name="plateau_whole", **fields)
    split = [write_train_yaml(train, dev, e, exp_name="plateau_split",
                              **fields)
             for e in (PLATEAU_KILL, PLATEAU_EPOCHS, PLATEAU_EPOCHS + 1)]
    rec = {}
    run_epoch, step = loop.Trainer.run_epoch, PlateauScheduler.step
    restore, save = loop.Trainer._restore_snapshot, loop.save_checkpoint

    def run_epoch_rec(self, loader, epoch, train, *a, **k):
        out = run_epoch(self, loader, epoch, train, *a, **k)
        if not train:
            rec["epoch"] = epoch
            rec["dev"][epoch] = out[1]
            rec["walls"].append(time.perf_counter())
        return out

    def step_rec(self, dev_loss, acc):
        e = rec["epoch"]
        rec["actions"][e] = step(self, PLATEAU_SEEN_LOSS[e],
                                 PLATEAU_SEEN_ACC[e])
        return rec["actions"][e]

    def restore_rec(self, snap):
        restore(self, snap)
        rec["installed"].append((rec["epoch"], {
            k: v.detach().cpu().clone()
            for k, v in self.model.state_dict().items()}))

    def save_rec(path, tag, *a, **k):
        t0 = time.perf_counter()
        out = save(path, tag, *a, **k)
        files = [out + x for x in (".pt", ".opt.pt", ".snap.pt",
                                   ".meta.json") if os.path.exists(out + x)]
        rec["saves"].append((tag, time.perf_counter() - t0,
                             {f[len(out):]: os.path.getsize(f)
                              for f in files}))
        return out

    def run(conf, *flags):
        rec.update(epoch=None, dev={}, actions={}, installed=[], saves=[],
                   walls=[time.perf_counter()])
        out = run_cli(["train", "--conf", conf, "--device", "cuda", *flags])
        return out, {k: v for k, v in rec.items() if k != "epoch"}

    loop.Trainer.run_epoch, PlateauScheduler.step = run_epoch_rec, step_rec
    loop.Trainer._restore_snapshot, loop.save_checkpoint = restore_rec, save_rec
    lstm_fwd_kernel.launches = lstm_bwd_kernel.launches = 0
    zero_path_launches()
    try:
        _, w = run(whole)
        _, first = run(split[0])
        at_kill = load_snapshots(str(WORK / "ckpt" / "plateau_split"),
                                 "latest")
        out, resumed = run(split[1], "--resume")
        (WORK / "ckpt" / "plateau_split" / "latest.snap.pt").unlink()
        old_out, _ = run(split[2], "--resume")
    finally:
        loop.Trainer.run_epoch, PlateauScheduler.step = run_epoch, step
        loop.Trainer._restore_snapshot, loop.save_checkpoint = restore, save
    launches = {"lstm_fwd": lstm_fwd_kernel.launches,
                "lstm_bwd": lstm_bwd_kernel.launches}
    record_path_launches("resume-plateau")
    epochs = 2 * PLATEAU_EPOCHS + 1
    steps = -(-TRAIN_UTTS // BATCH) * epochs
    forwards = steps + -(-DEV_UTTS // BATCH) * epochs
    if f"resumed from epoch {PLATEAU_KILL}" not in out:
        raise AssertionError("[resume-plateau] the second run did not resume")
    old = [line for line in old_out.splitlines()
           if "resumed from" in line or "no plateau snapshots" in line]
    if (len(old) != 2 or f"resumed from epoch {PLATEAU_EPOCHS}" not in old[1]
            or f"Epoch {PLATEAU_EPOCHS + 1} Valid done" not in old_out):
        raise AssertionError(f"[resume-plateau] a latest without its "
                             f"snapshot file: {old}")
    actions = {e: str(a) for e, a in w["actions"].items()}
    split_actions = {e: str(a) for e, a in {**first["actions"],
                                            **resumed["actions"]}.items()}
    installs = [e for e, _ in resumed["installed"]]
    snap = at_kill["snapshot"][0] if at_kill and at_kill["snapshot"] else None
    if snap is None or not installs or installs[0] != PLATEAU_KILL + 1:
        raise AssertionError(f"[resume-plateau] latest at epoch "
                             f"{PLATEAU_KILL} held no snapshot, or the "
                             f"resumed run restored at epochs {installs}")
    got = resumed["installed"][0][1]
    same = got.keys() == snap.keys() and all(torch.equal(got[k], snap[k])
                                             for k in snap)
    dev_w = [w["dev"][e] for e in sorted(w["dev"])]
    dev_s = [{**first["dev"], **resumed["dev"]}[e] for e in sorted(w["dev"])]
    dev_rel = max(abs(a - b) / abs(b) for a, b in zip(dev_s, dev_w))
    epoch_s = [round(b - a, 3) for run_rec in (w, first, resumed)
               for a, b in zip(run_rec["walls"], run_rec["walls"][1:])]
    latest = [(sec, sizes) for run_rec in (w, first, resumed)
              for tag, sec, sizes in run_rec["saves"] if tag == "latest"]
    log(f"[resume-plateau] {PLATEAU_EPOCHS} epochs vs {PLATEAU_KILL} + "
        f"--resume to {PLATEAU_EPOCHS}, dropout 0, latest every epoch: the "
        f"epoch-{installs[0]} restore installs latest's epoch-"
        f"{PLATEAU_KILL} snapshot {'bit for bit' if same else 'NOT EQUAL'} "
        f"({len(snap)} tensors); plateau actions by epoch {actions} vs "
        f"{split_actions}; a latest without its snapshot file resumes to "
        f"epoch {PLATEAU_EPOCHS + 1}: {old}")
    log(f"[resume-plateau] dev loss by epoch, uninterrupted "
        f"{[round(v, 6) for v in dev_w]} vs killed + resumed "
        f"{[round(v, 6) for v in dev_s]}: max rel {dev_rel:.2e} (expected "
        f"within {PLATEAU_DEV_RTOL}, not gating: cuDNN's backward is not "
        f"bit-deterministic); launches {launches} over {steps} train steps "
        f"and {forwards} forwards")
    log(f"[resume-plateau] epoch walls (s; each saves latest, the first of "
        f"a run includes its set-up) {epoch_s}; latest's writes on the save "
        f"thread {[round(sec, 3) for sec, _ in latest]} s, "
        f"{sum(latest[-1][1].values())} bytes each, by file "
        f"{latest[-1][1]} ({card})")
    if not same:
        raise AssertionError("[resume-plateau] the first restore after the "
                             "resume did not install latest's snapshot")
    if actions != split_actions:
        raise AssertionError("[resume-plateau] the runs took other plateau "
                             "actions")
    if not all(math.isfinite(v) for v in dev_w + dev_s):
        raise AssertionError(f"[resume-plateau] dev losses {dev_w} {dev_s}")
    if (launches["lstm_bwd"] != lstm_per_pass() * steps
            or launches["lstm_fwd"] < lstm_per_pass() * forwards):
        raise AssertionError(f"[resume-plateau] launches {launches} for "
                             f"{forwards} forwards / {steps} train steps: "
                             "a layer bypassed the kernels")
    return launches


HANDOVER_EPOCHS = 2     # phase resume-mdd_tpu: epochs the port trains on
HANDOVER_RTOL = 1e-3    # the first resumed step's loss, orbax vs `.pt`
# resume: the card's training is not bit-deterministic (resume-plateau)


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def phase_resume_mdd_tpu(torch, train, dev, card: str) -> dict:
    """An mdd_tpu run handed to the port at full width (the module
    docstring's 10c); -> the launches of the resumed runs by kernel."""
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.convert import torch_adam_to_optax, torch_to_flax
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.ops.lstm_cuda import lstm_bwd_kernel, lstm_fwd_kernel
    from mdd_tpu_torch.train import loop
    from mdd_tpu_torch.train.checkpoint import (checkpoint_format,
                                                load_checkpoint,
                                                load_optimizer_state,
                                                load_snapshots,
                                                save_checkpoint)
    from mdd_tpu_torch.train.orbax_format import (read_orbax_checkpoint,
                                                  save_mdd_tpu_checkpoint)
    from mdd_tpu_torch.utils.config import load_config

    began = time.perf_counter()
    # (a) resume-plateau's uninterrupted run's `latest`, dropout 0
    src = str(WORK / "ckpt" / "plateau_whole")
    state, meta = load_checkpoint(src, "latest")
    opt_state = load_optimizer_state(src, "latest")
    start = meta["epoch"]
    fields = dict(drop_out=0.0, end_adjust_acc=1000.0, plateau_patience=2,
                  checkpoint_every=1)
    conf = write_train_yaml(train, dev, start + HANDOVER_EPOCHS,
                            exp_name="handover", **fields)
    conf_pt = write_train_yaml(train, dev, start + 1,
                               exp_name="handover_pt", **fields)
    cfg = load_config(conf)
    vocab = Vocab.from_units_file(cfg.vocab_file)
    orbax_dir = WORK / "ckpt" / "handover"
    pt_dir = WORK / "ckpt" / "handover_pt"
    model = cli.build_trainer(cfg, vocab, "cuda").model   # for its names

    # (b) mdd_tpu's format, written and read back; the `.pt` beside it
    t0 = time.perf_counter()
    params, stats = torch_to_flax(state)
    tree = {"params": params, "batch_stats": stats,
            "opt_state": torch_adam_to_optax(opt_state, model)}
    map_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_mdd_tpu_checkpoint(str(orbax_dir), "latest", state, meta,
                            opt_state, model)
    write_s = time.perf_counter() - t0
    orbax_bytes = dir_bytes(orbax_dir / "latest")
    t0 = time.perf_counter()
    back = read_orbax_checkpoint(str(orbax_dir / "latest"))
    read_s = time.perf_counter() - t0
    sha = leaves_sha256(tree)
    if leaves_sha256(back) != sha:
        raise AssertionError("[resume-mdd_tpu] the orbax latest reads back "
                             "other leaves than were written")
    t0 = time.perf_counter()
    save_checkpoint(str(pt_dir), "latest", state, meta, opt_state,
                    load_snapshots(src, "latest"))
    pt_write_s = time.perf_counter() - t0
    pt_bytes = {p.name: p.stat().st_size for p in sorted(pt_dir.iterdir())}
    del tree, back

    # (c) two fresh Trainers on the card, from the `.pt` and from orbax
    restored = {}
    for kind, path in (("torch", pt_dir), ("orbax", orbax_dir)):
        tr = cli.build_trainer(cfg, vocab, "cuda")
        t0 = time.perf_counter()
        epoch = tr.restore(str(path.parent), path.name, "latest",
                           log=lambda *_: None)
        torch.cuda.synchronize()
        restored[kind] = dict(
            seconds=time.perf_counter() - t0, epoch=epoch,
            kind=tr.checkpoint_kind, model=tr.model.state_dict(),
            opt=tr.optimizer.state_dict(),
            scheduler=dataclasses.asdict(tr.scheduler),
            histories=(tr.loss_results, tr.dev_loss_results,
                       tr.dev_acc_results))
    a, b = restored["torch"], restored["orbax"]
    same = (a["epoch"] == b["epoch"] == start
            and (a["kind"], b["kind"]) == ("torch", "orbax")
            and a["model"].keys() == b["model"].keys()
            and all(torch.equal(a["model"][k], b["model"][k])
                    for k in a["model"])
            and a["opt"]["state"].keys() == b["opt"]["state"].keys()
            and all(x.keys() == b["opt"]["state"][i].keys()
                    and all(torch.equal(v, b["opt"]["state"][i][k])
                            for k, v in x.items())
                    for i, x in a["opt"]["state"].items())
            and a["opt"]["param_groups"] == b["opt"]["param_groups"]
            and a["scheduler"] == b["scheduler"]
            and a["histories"] == b["histories"])
    n_opt = sum(len(x) for x in a["opt"]["state"].values())
    adam_step = int(next(iter(opt_state["state"].values()))["step"])
    log(f"[resume-mdd_tpu] epoch-{start} latest at full width "
        f"({sum(v.numel() for v in state.values())} weights and "
        f"statistics, Adam step {adam_step}): "
        f"mapped to mdd_tpu's trees in {map_s:.3f} s; written in its orbax "
        f"format in {write_s:.3f} s, {orbax_bytes} bytes; read back in "
        f"{read_s:.3f} s, SHA-256 {sha[:16]} equal to the tree written; "
        f"the port's .pt of it (with the snapshots) in {pt_write_s:.3f} s, "
        f"{pt_bytes} bytes; restored on the card from the .pt in "
        f"{a['seconds']:.3f} s, from orbax in {b['seconds']:.3f} s: "
        f"{'bit for bit' if same else 'NOT EQUAL'} ({len(a['model'])} "
        f"model tensors, {n_opt} optimizer tensors, lr "
        f"{b['opt']['param_groups'][0]['lr']}, scheduler, histories) "
        f"({card})")
    if not same:
        raise AssertionError("[resume-mdd_tpu] the orbax and .pt restores "
                             "differ")
    del restored, a, b

    # (d) `train --resume` on the orbax directory, and on the `.pt`
    rec = {"first": None, "latest": None, "saves": []}
    train_step, save = loop.Trainer.train_step, loop.save_checkpoint

    def train_step_rec(self, arrays, acc):
        out = train_step(self, arrays, acc)
        if rec["first"] is None:
            rec["first"] = (out[0] - acc[0]).item()
        return out

    def save_rec(path, tag, state_dict, meta, optimizer_state=None,
                 snapshots=None, kind="torch", model=None):
        t0 = time.perf_counter()
        out = save(path, tag, state_dict, meta, optimizer_state, snapshots,
                   kind, model)
        rec["saves"].append((os.path.basename(path), tag, kind,
                             round(time.perf_counter() - t0, 3)))
        if tag == "latest" and out == str(orbax_dir / "latest"):
            rec["latest"] = (state_dict, optimizer_state)
        return out

    loop.Trainer.train_step, loop.save_checkpoint = train_step_rec, save_rec
    lstm_fwd_kernel.launches = lstm_bwd_kernel.launches = 0
    zero_path_launches()
    try:
        t0 = time.perf_counter()
        out = run_cli(["train", "--conf", conf, "--device", "cuda",
                       "--resume"])
        wall = time.perf_counter() - t0
        first = rec["first"]
        rec["first"] = None
        out_pt = run_cli(["train", "--conf", conf_pt, "--device", "cuda",
                          "--resume"])
        first_pt = rec["first"]
    finally:
        loop.Trainer.train_step, loop.save_checkpoint = train_step, save
    launches = {"lstm_fwd": lstm_fwd_kernel.launches,
                "lstm_bwd": lstm_bwd_kernel.launches}
    record_path_launches("resume-mdd_tpu")
    epochs = HANDOVER_EPOCHS + 1
    steps = -(-TRAIN_UTTS // BATCH) * epochs
    forwards = steps + -(-DEV_UTTS // BATCH) * epochs
    resumed = [line for line in out.splitlines() if "resumed from" in line]
    loss_rel = abs(first - first_pt) / abs(first_pt)

    # (e) what the run left
    end = start + HANDOVER_EPOCHS
    names = sorted(os.listdir(orbax_dir))
    meta_end = json.loads((orbax_dir / "latest.meta.json").read_text())
    snap_epoch = load_snapshots(str(orbax_dir), "latest")["epoch"]
    want_state, want_opt = rec["latest"]
    got_state, _ = load_checkpoint(str(orbax_dir), "latest")
    got_opt = load_optimizer_state(str(orbax_dir), "latest", model,
                                   cfg.weight_decay)
    lr32 = torch.tensor(want_opt["param_groups"][0]["lr"],
                        dtype=torch.float32).item()
    final_same = (
        got_state.keys() == want_state.keys()
        and all(torch.equal(got_state[k], want_state[k].cpu())
                for k in want_state)
        and got_opt["state"].keys() == want_opt["state"].keys()
        and all(torch.equal(v, want_opt["state"][i][k].cpu())
                for i, x in got_opt["state"].items() for k, v in x.items())
        and got_opt["param_groups"][0]["lr"] == lr32)
    log(f"[resume-mdd_tpu] train --resume on the orbax directory to epoch "
        f"{end} in {wall:.1f} s: {resumed}; first resumed step's loss "
        f"{first!r} vs the .pt resume's {first_pt!r} (rel {loss_rel:.2e}, "
        f"limit {HANDOVER_RTOL}); saves (exp, tag, format, s on their "
        f"thread) {rec['saves']}; left {names}, meta epoch "
        f"{meta_end['epoch']}, snapshot file epoch {snap_epoch}; latest/ "
        f"read back through the map "
        f"{'equals' if final_same else 'DIFFERS FROM'} the trainer's last "
        f"latest bit for bit; launches {launches} over {steps} train steps "
        f"and {forwards} forwards; the phase in "
        f"{time.perf_counter() - began:.1f} s ({card})")
    if not (len(resumed) == 1 and f"resumed from epoch {start} (" in
            resumed[0] and resumed[0].endswith("mdd_tpu's orbax latest/")
            and f"resumed from epoch {start} (" in out_pt
            and "of the port's latest.pt" in out_pt):
        raise AssertionError(f"[resume-mdd_tpu] resume lines {resumed}")
    if not loss_rel <= HANDOVER_RTOL:
        raise AssertionError(f"[resume-mdd_tpu] first resumed step's loss "
                             f"{first} vs {first_pt}")
    if not (names == ["best", "best.meta.json", "latest", "latest.meta.json",
                      "latest.snap.pt"]
            and checkpoint_format(str(orbax_dir), "latest") == "orbax"
            and checkpoint_format(str(orbax_dir), "best") == "orbax"
            and meta_end["epoch"] == snap_epoch == end):
        raise AssertionError(f"[resume-mdd_tpu] the run left {names}, meta "
                             f"epoch {meta_end['epoch']}, snapshots of "
                             f"epoch {snap_epoch}")
    if not final_same:
        raise AssertionError("[resume-mdd_tpu] latest/ does not hold the "
                             "trainer's last state")
    if (launches["lstm_bwd"] != lstm_per_pass() * steps
            or launches["lstm_fwd"] < lstm_per_pass() * forwards):
        raise AssertionError(f"[resume-mdd_tpu] launches {launches} for "
                             f"{forwards} forwards / {steps} train steps: "
                             "a layer bypassed the kernels")
    return launches


FWD_TIMING_BATCHES = (1, 16, 64)   # serving, serving groups, train/evaluate
# train at B=16 and 64; the quality recipe's 256 and bench.py's 512
BWD_TIMING_BATCHES = (16, 64, 256, 512)


def phase_timing(torch, card: str) -> tuple:
    """lstm_fwd at the batches of the main paths, then lstm_bwd at the
    training batches; -> ({B: forward timing}, {B: backward timing})."""
    from mdd_tpu_torch.utils.precision import strict_float32

    strict_float32("cuda", "float32")   # torch.nn.LSTM's cuDNN yardstick
    g = torch.Generator().manual_seed(SEED)
    fwd = {b: timing_fwd(torch, 80, b, g, card) for b in FWD_TIMING_BATCHES}
    return fwd, {b: timing_bwd(torch, 80, b, g, card)
                 for b in BWD_TIMING_BATCHES}


def timing_fwd(torch, t: int, b: int, g, card: str) -> dict:
    """lstm_fwd at (T', B), float32: the kernel, its plain version, its
    bound, its plan; one BiLSTM layer through the port (input projection +
    kernel), through the plain loop, and one torch.nn.LSTM call as the
    yardstick: a whole layer, its input projection included."""
    from mdd_tpu_torch.ops.lstm import bilstm
    from mdd_tpu_torch.ops.lstm_cuda import (
        bilstm_cuda,
        lstm_fwd_kernel,
        lstm_seq_fwd_reference,
    )

    d_in = 2 * H
    s = H ** -0.5
    x = torch.randn((t, b, d_in), generator=g).cuda()
    w = [((torch.rand(shape, generator=g) * 2 - 1) * s).cuda()
         for shape in ((d_in, 4 * H), (H, 4 * H)) * 2]
    x_proj = (torch.randn((t, 2, b, 4 * H), generator=g) * 0.5).cuda()
    w_hh = torch.stack([w[1], w[3]])
    lib = torch.nn.LSTM(d_in, H, bidirectional=True, bias=False).cuda()
    with torch.inference_mode():
        hs, _ = lstm_fwd_kernel(x_proj, w_hh)
        err = (hs - lstm_seq_fwd_reference(x_proj, w_hh)[0]).abs().max().item()
        ms = cuda_ms(lambda: lstm_fwd_kernel(x_proj, w_hh), 50)
        plain_ms = cuda_ms(lambda: lstm_seq_fwd_reference(x_proj, w_hh), 10)
        layer_ms = cuda_ms(lambda: bilstm_cuda(x, *w), 50)
        layer_plain_ms = cuda_ms(lambda: bilstm(x, *w), 10)
        library_ms = cuda_ms(lambda: lib(x), 50)
    bnd, bound_by = lstm_bound_ms(t, b, H, "float32")
    plan = lstm_fwd_kernel.plan(b, H, torch.float32)
    log(f"[timing] float32, B={b} T'={t} H={H}: lstm_fwd kernel {ms:.4f} ms "
        f"({ms * 1e3 / t:.2f} us a step; {plan['blocks']} blocks of "
        f"{8 * plan['unit_groups']} units x 16 rows, "
        f"{plan['smem_bytes']} B shared, w_hh split at load "
        f"{bool(plan['split_w'])}, {plan['launches']} launch(es) of "
        f"{plan['chunk_rows']} rows, global barrier, no cluster), plain "
        f"lstm_seq_fwd_reference {plain_ms:.4f} ms, bound {bnd:.4f} ms "
        f"({bound_by}) ({card})")
    log(f"[timing] float32, B={b} T'={t}: BiLSTM layer (768 -> 2x384): port "
        f"bilstm_cuda {layer_ms:.4f} ms, plain bilstm {layer_plain_ms:.4f} "
        f"ms, torch.nn.LSTM (whole layer, input projection included) "
        f"{library_ms:.4f} ms ({card})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": bound_by, "library_ms": library_ms,
            "timing_err": err}


def timing_bwd(torch, t: int, b: int, g, card: str) -> dict:
    """lstm_bwd at (T', B), float32: the backward, its launches one by one
    (each product with its effective rate: the float32 operations of the
    product over its time), its plain version, its bound, and the backward
    of one cuDNN torch.nn.LSTM layer as the yardstick (its forward+backward
    minus its forward)."""
    from mdd_tpu_torch.ops.lstm_cuda import (
        lstm_bwd_kernel,
        lstm_fwd_kernel,
        lstm_seq_bwd_reference,
    )

    s = H ** -0.5
    x_proj = (torch.randn((t, 2, b, 4 * H), generator=g) * 0.5).cuda()
    w_hh = ((torch.rand((2, H, 4 * H), generator=g) * 2 - 1) * s).cuda()
    dhs = torch.randn((t, 2, b, H), generator=g).cuda()
    with torch.no_grad():
        hs, cs = lstm_fwd_kernel(x_proj, w_hh)
        fwd_ms = cuda_ms(lambda: lstm_fwd_kernel(x_proj, w_hh), 20)
        ms = cuda_ms(lambda: lstm_bwd_kernel(x_proj, w_hh, hs, cs, dhs), 20)
        plain_ms = cuda_ms(
            lambda: lstm_seq_bwd_reference(x_proj, w_hh, hs, cs, dhs), 3)
        k = lstm_bwd_kernel
        buffers = k.buffers(x_proj)
        part_ms = {name: cuda_ms(lambda: k.run_parts(
            x_proj, w_hh, hs, cs, dhs, buffers, part), 20)
            for name, part in (("all", k.ALL), ("z", k.Z_PRODUCT),
                               ("chain", k.CHAIN), ("dw", k.DW_PRODUCT))}
    plan = lstm_bwd_kernel.plan(t, b, H, torch.float32)
    dot_flops = 2 * 2 * b * H * 4 * H        # one step's dot, 2 directions
    z_tflops = t * dot_flops / part_ms["z"] / 1e9
    dw_tflops = (t - 1) * dot_flops / part_ms["dw"] / 1e9
    log(f"[timing] float32, B={b} T'={t}: lstm_bwd launches one by one: "
        f"pre-activation product {part_ms['z']:.4f} ms ({z_tflops:.1f} "
        f"TFLOP/s effective), recurrence {part_ms['chain']:.4f} ms "
        f"({part_ms['chain'] * 1e3 / max(t - 1, 1):.2f} us a step; "
        f"{plan['launches']} launch(es) of {plan['chunk_rows']} rows, "
        f"{plan['blocks']} blocks of {8 * plan['unit_groups']} units x "
        f"16 rows, {plan['smem_bytes']} B shared), "
        f"dW_hh product + reduce {part_ms['dw']:.4f} ms ({dw_tflops:.1f} "
        f"TFLOP/s effective, {plan['k_slices']} slices); with reused "
        f"buffers {part_ms['all']:.4f} ms ({card})")
    lib = torch.nn.LSTM(2 * H, H, bidirectional=True, bias=False).cuda()
    x = torch.randn((t, b, 2 * H), generator=g).cuda().requires_grad_()
    dy = torch.randn((t, b, 2 * H), generator=g).cuda()
    lib_fwd = cuda_ms(lambda: lib(x)[0], 20)
    lib_both = cuda_ms(lambda: lib(x)[0].backward(dy), 20)
    bnd, bound_by = lstm_bwd_bound_ms(t, b, H, "float32")
    log(f"[timing] float32, B={b} T'={t}: lstm_bwd kernel {ms:.4f} ms "
        f"(lstm_fwd at this shape {fwd_ms:.4f} ms), plain "
        f"lstm_seq_bwd_reference {plain_ms:.4f} ms, bound {bnd:.4f} ms "
        f"({bound_by}); torch.nn.LSTM layer backward (fwd+bwd "
        f"{lib_both:.4f} - fwd {lib_fwd:.4f}) {lib_both - lib_fwd:.4f} ms "
        f"({card})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": bound_by, "library_ms": lib_both - lib_fwd,
            "parts_ms": {name: part_ms[name] for name in ("z", "chain", "dw")},
            "product_tflops": {"z": z_tflops, "dw": dw_tflops}}


def phase_kernel_dropout(torch) -> float:
    """fused_dropout_kernel == fused_dropout_reference, bit for bit; ->
    the largest |kernel - plain| seen (0.0 or the phase raises)."""
    from mdd_tpu_torch.ops.dropout_cuda import (
        SITES,
        fused_dropout,
        fused_dropout_kernel,
        fused_dropout_reference,
    )

    g = torch.Generator().manual_seed(SEED + 4)
    shapes = list(SITES.items()) + [
        (f"n={n}", (n,)) for n in (1, 3, 1023, 9_000_001)] + [
        ("7x129", (7, 129))]
    worst, checked = 0.0, 0
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        bits = torch.int32 if dtype == "float32" else torch.int16
        for name, shape in shapes:
            x = torch.randn(shape, generator=g).to("cuda", dt)
            for rate in (0.1, 0.2, 0.5):
                seed = torch.randint(0, 2 ** 63 - 1, (1,), generator=g).cuda()
                before = fused_dropout_kernel.launches
                out = fused_dropout_kernel(x, seed, rate)
                torch.cuda.synchronize()
                if fused_dropout_kernel.launches != before + 1:
                    raise AssertionError("fused_dropout did not count its "
                                         "launch")
                ref = fused_dropout_reference(x, seed, rate)
                same = torch.equal(out.view(bits), ref.view(bits))
                err = (out.float() - ref.float()).abs().max().item()
                worst = max(worst, err)
                n, keep = x.numel(), 1.0 - rate
                kept = (out != 0).sum().item() / n
                sigma = (keep * rate / n) ** 0.5
                if not same:
                    raise AssertionError(
                        f"fused_dropout {dtype} {name} rate {rate} differs "
                        f"from its plain version (max abs {err})")
                if n >= 1000 and abs(kept - keep) > 4 * sigma:
                    raise AssertionError(
                        f"fused_dropout {dtype} {name} rate {rate}: kept "
                        f"share {kept} is over 4 sigma from {keep}")
                checked += 1
            log(f"  fused_dropout {dtype} {name} {tuple(shape)}: bit for bit "
                f"its plain version at rates 0.1, 0.2, 0.5; kept share at "
                f"0.5: {kept:.6f}")
        # storage one element off 16-byte alignment: the scalar path
        x = torch.randn(4099, generator=g).to("cuda", dt)[1:]
        seed = torch.tensor([SEED + 7], device="cuda")
        if not torch.equal(fused_dropout_kernel(x, seed, 0.2).view(bits),
                           fused_dropout_reference(x, seed, 0.2).view(bits)):
            raise AssertionError(f"fused_dropout {dtype} on unaligned "
                                 "storage differs from its plain version")
        checked += 1
    # autograd: the backward regenerates the forward's mask
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # x > 0, so that out != 0 is the mask (a normal draw of this size holds
    # a few exact zeros on the card)
    x = (torch.rand(SITES["bilstm"], device="cuda") + 0.5).requires_grad_()
    dy = torch.randn((BATCH, 110, 2 * H), device="cuda").transpose(0, 1)
    before = fused_dropout_kernel.launches
    out = fused_dropout(x, 0.2, gen)
    out.backward(dy)
    torch.cuda.synchronize()
    mask = out != 0
    scale = torch.tensor(1.0 / 0.8, dtype=torch.float32, device="cuda")
    made = fused_dropout_kernel.launches - before
    wrong = (x.grad != torch.where(mask, dy * scale, 0.0)).sum().item()
    if made != 2 or wrong:
        raise AssertionError(
            f"fused_dropout forward + backward made {made} launches (want "
            f"2) and {wrong} gradient entries differ from mask / keep * dy "
            "with the forward's mask")
    other = fused_dropout(x.detach(), 0.2, gen) != 0
    differ = (other != mask).float().mean().item()
    if not 0.2 < differ < 0.45:      # independent masks differ on 2 * .8 * .2
        raise AssertionError(f"two seeds' masks differ on {differ} of the "
                             "elements, not about 0.32")
    log(f"[kernel-dropout] fused_dropout equals fused_dropout_reference bit "
        f"for bit in {checked} cases (max abs err {worst}); gradient = mask "
        f"/ keep * dy; two seeds' masks differ on {differ:.4f} of the "
        "elements")
    return worst


def step_losses(lines) -> list:
    """Each step's own loss from the running means `run_epoch` prints."""
    means = [float(m.group(1)) for l in lines for m in
             [re.search(r"Epoch = 1, step = \d+, total_loss = (\S+?),", l)]
             if m]
    return [means[0]] + [(i + 1) * means[i] - i * means[i - 1]
                         for i in range(1, len(means))]


def phase_train_fused(torch, conf: str, card: str) -> dict:
    """One epoch with use_fused_dropout=True through the entry points
    `train` uses; -> the launch counts of the path and the YAML's config."""
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.ops.dropout_cuda import fused_dropout_kernel
    from mdd_tpu_torch.ops.lstm_cuda import lstm_bwd_kernel, lstm_fwd_kernel
    from mdd_tpu_torch.utils.config import load_config

    cfg = load_config(conf)
    cfg.exp_name, cfg.num_epoches = "smoke_fused", FUSED_EPOCHS
    vocab = Vocab.from_units_file(cfg.vocab_file)
    loaders = [cli._build_loader(cfg, vocab, *paths, train=train)
               for paths, train in (
                   ((cfg.train_scp_path, cfg.train_lab_path,
                     cfg.train_trans_path), True),
                   ((cfg.valid_scp_path, cfg.valid_lab_path,
                     cfg.valid_trans_path), False))]
    trainer = cli.build_trainer(cfg, vocab, "cuda", use_fused_dropout=True)
    lines = []
    kernels = (fused_dropout_kernel, lstm_fwd_kernel, lstm_bwd_kernel)
    for k in kernels:
        k.launches = 0
    zero_path_launches()
    t0 = time.perf_counter()
    trainer.fit(*loaders, num_epochs=FUSED_EPOCHS, print_every=1,
                checkpoint_dir=cfg.checkpoint_dir, exp_name=cfg.exp_name,
                log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drops, fwd, bwd = (k.launches for k in kernels)
    record_path_launches("train-fused")
    steps = -(-TRAIN_UTTS // BATCH) * FUSED_EPOCHS
    forwards = steps + -(-DEV_UTTS // BATCH) * FUSED_EPOCHS
    losses = step_losses(lines)            # the first epoch's steps
    epochs = [float(v) for l in lines for v in
              re.findall(r"Train done, total_loss: (\S+?),", l)]
    for line in lines:
        if "done" in line:
            log(f"[train-fused]   {line}")
    log(f"[train-fused] {FUSED_EPOCHS} epochs of {TRAIN_UTTS} utterances at "
        f"B={BATCH} with use_fused_dropout in {wall:.1f} s; first epoch's "
        f"step losses {losses[0]:.4f} -> {losses[-1]:.4f}, epoch losses "
        f"{epochs}; fused_dropout launches {drops} over {steps} train "
        f"steps, lstm_fwd {fwd} over {forwards} forwards, lstm_bwd {bwd}")
    if (len(losses) * FUSED_EPOCHS != steps or len(epochs) != FUSED_EPOCHS
            or not all(math.isfinite(v) for v in losses + epochs)):
        raise AssertionError(f"losses missing or not finite: {losses}, "
                             f"{epochs}")
    if not (losses[-1] < losses[0] and epochs[-1] < epochs[0]):
        raise AssertionError(f"the loss did not fall: {losses}, {epochs}")
    if (drops != 12 * steps or bwd != lstm_per_pass() * steps
            or fwd != lstm_per_pass() * forwards):
        raise AssertionError(
            f"{drops} dropout / {fwd} lstm_fwd / {bwd} lstm_bwd launches for "
            f"{steps} train steps and {forwards} forwards: a site or a layer "
            "bypassed its kernel")
    meta = json.loads((Path(cfg.checkpoint_dir) / cfg.exp_name
                       / "best.meta.json").read_text())
    if meta["model_config"].get("use_fused_dropout") is not True:
        raise AssertionError("best.meta.json does not carry "
                             "use_fused_dropout")
    compare_dropout_steps(torch, cfg, vocab, card)
    return {"fused_dropout": drops, "lstm_fwd": fwd, "lstm_bwd": bwd}


def compare_dropout_steps(torch, cfg, vocab, card: str) -> None:
    """Train steps at B=64 from the epoch's `latest`, with fused and with
    plain dropout in turns (plain, fused, fused, plain): each pass's median
    step time, and the device time of 3 profiled steps of each."""
    from torch.profiler import ProfilerActivity, profile

    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.dataset import pad_batch_to

    trainers = {}
    for name, fused in (("plain", False), ("fused", True)):
        tr = cli.build_trainer(cfg, vocab, "cuda", use_fused_dropout=fused)
        tr.restore(cfg.checkpoint_dir, cfg.exp_name, "latest")
        trainers[name] = tr
    loader = cli._build_loader(cfg, vocab, cfg.train_scp_path,
                               cfg.train_lab_path, cfg.train_trans_path,
                               train=True)
    batches = [pad_batch_to(b, BATCH) for b in loader]
    acc = torch.zeros(4, device="cuda")
    medians = {"plain": [], "fused": []}
    for name in ("plain", "fused", "fused", "plain"):
        tr, secs = trainers[name], []
        for padded, valid in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acc = tr.train_step(tr.batch_arrays(padded, valid), acc)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        medians[name].append(statistics.median(secs) * 1e3)
    busy = {}
    for name, tr in trainers.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for padded, valid in batches[:3]:
                acc = tr.train_step(tr.batch_arrays(padded, valid), acc)
            torch.cuda.synchronize()
        events = device_ops(prof)
        busy[name] = (sum(e.self_device_time_total for e in events) / 3e3,
                      sum(e.count for e in events) // 3)
        if name == "fused":
            for e in events:
                if "dropout_kernel" in e.key:
                    log(f"[train-fused]   {e.self_device_time_total / 3e3:.3f}"
                        f" ms a step in {e.count // 3} launches of "
                        f"{e.key[:70]}")
    log(f"[train-fused] step time at B={BATCH}, median of {len(batches)} "
        f"steps, passes in turn: plain dropout {medians['plain'][0]:.2f} / "
        f"{medians['plain'][1]:.2f} ms, fused {medians['fused'][0]:.2f} / "
        f"{medians['fused'][1]:.2f} ms; device time a step (3 profiled): "
        f"plain {busy['plain'][0]:.2f} ms in {busy['plain'][1]} ops, fused "
        f"{busy['fused'][0]:.2f} ms in {busy['fused'][1]} ops ({card})")


def text_turns(torch, trainer, batches, tag: str, card: str) -> dict:
    """Train steps over `batches` with the text BiLSTM on the scan-contract
    kernels (bilstm_scan_cuda) and on the plain loop (bilstm), in turns
    (kernels, plain, plain, kernels): the step medians; then
    torch.profiler over the first batches (at most 3) of each: device ops
    and busy share a step.  -> {"kernels" / "plain": {"median_ms": [..],
    "ops_per_step": n}}."""
    from torch.profiler import ProfilerActivity, profile

    from mdd_tpu_torch.ops.lstm import bilstm
    from mdd_tpu_torch.ops.lstm_cuda import bilstm_scan_cuda

    text = trainer.model.text.lstm
    if text.rnn is not bilstm_scan_cuda:
        raise AssertionError("the bfloat16 text BiLSTM is not on the scan "
                             "kernels")
    variants = {"kernels": bilstm_scan_cuda, "plain": bilstm}
    out = {k: {"median_ms": []} for k in variants}
    acc = torch.zeros(4, device="cuda")
    try:
        for which in ("kernels", "plain", "plain", "kernels"):
            text.rnn = variants[which]
            turn = []
            for arrays in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                acc = trainer.train_step(arrays, acc)
                torch.cuda.synchronize()
                turn.append(time.perf_counter() - t0)
            out[which]["median_ms"].append(
                round(statistics.median(turn) * 1e3, 2))
        for which in variants:
            text.rnn = variants[which]
            window = batches[:3]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for arrays in window:
                    acc = trainer.train_step(arrays, acc)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            ops = report_profile(prof, wall_us, tag,
                                 f"{len(window)} bf16 train steps, the text "
                                 f"BiLSTM on {which}", card)
            out[which]["ops_per_step"] = ops / len(window)
    finally:
        text.rnn = bilstm_scan_cuda
    log(f"[{tag}] step median with the text BiLSTM on the scan kernels "
        f"{out['kernels']['median_ms']} ms, on the plain loop "
        f"{out['plain']['median_ms']} ms (in turns: kernels, plain, plain, "
        f"kernels; {len(batches)} steps each); device ops a step "
        f"{out['kernels']['ops_per_step']:.1f} against "
        f"{out['plain']['ops_per_step']:.1f} ({card})")
    return out


def phase_train_bf16(torch, train, dev, card: str) -> dict:
    """One epoch of the flagship recipe in bfloat16 with use_fused_dropout
    through the entry points `train` uses, then its step time, with the
    text BiLSTM on the scan kernels against the plain loop; -> the launch
    counts of the epoch."""
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.dataset import pad_batch_to
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.ops.dropout_cuda import fused_dropout_kernel
    from mdd_tpu_torch.ops.lstm_cuda import (
        lstm_bwd_kernel,
        lstm_fwd_kernel,
        lstm_scan_bwd_kernel,
        lstm_scan_fwd_kernel,
    )
    from mdd_tpu_torch.utils.config import load_config

    cfg = load_config(write_train_yaml(train, dev, 1, "bfloat16"))
    cfg.exp_name = "smoke_bf16"
    vocab = Vocab.from_units_file(cfg.vocab_file)
    loaders = [cli._build_loader(cfg, vocab, *paths, train=is_train)
               for paths, is_train in (
                   ((cfg.train_scp_path, cfg.train_lab_path,
                     cfg.train_trans_path), True),
                   ((cfg.valid_scp_path, cfg.valid_lab_path,
                     cfg.valid_trans_path), False))]
    trainer = cli.build_trainer(cfg, vocab, "cuda", use_fused_dropout=True)
    if trainer.model.dtype != torch.bfloat16:
        raise AssertionError("compute_dtype bfloat16 did not reach the model")
    kernels = (fused_dropout_kernel, lstm_fwd_kernel, lstm_bwd_kernel)
    for k in kernels:
        k.launches = 0
    zero_path_launches()
    lines = []
    t0 = time.perf_counter()
    trainer.fit(*loaders, num_epochs=1, print_every=1,
                checkpoint_dir=cfg.checkpoint_dir, exp_name=cfg.exp_name,
                log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drops, fwd, bwd = (k.launches for k in kernels)
    scan_fwd, scan_bwd = (lstm_scan_fwd_kernel.launches,
                          lstm_scan_bwd_kernel.launches)
    record_path_launches("train-bf16")
    steps = -(-TRAIN_UTTS // BATCH)
    forwards = steps + -(-DEV_UTTS // BATCH)
    losses = step_losses(lines)
    dev_line = next(l for l in lines if "Valid done" in l)
    log(f"[train-bf16] 1 epoch of {TRAIN_UTTS} utterances at B={BATCH}, "
        f"compute_dtype bfloat16, use_fused_dropout, in {wall:.1f} s: step "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}; {dev_line}; "
        f"fused_dropout launches {drops} over {steps} train steps, lstm_fwd "
        f"{fwd} over {forwards} forwards, lstm_bwd {bwd}, lstm_scan_fwd "
        f"{scan_fwd}, lstm_scan_bwd {scan_bwd}")
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses missing or not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the bfloat16 loss did not fall: {losses}")
    # in bfloat16 the text BiLSTM runs on the scan kernels, the acoustic
    # layers on lstm_fwd / lstm_bwd
    layers = lstm_per_pass("bfloat16")
    if (drops != 12 * steps or bwd != layers * steps
            or fwd != layers * forwards or scan_fwd != forwards
            or scan_bwd != steps):
        raise AssertionError(
            f"{drops} dropout / {fwd} lstm_fwd / {bwd} lstm_bwd / {scan_fwd} "
            f"lstm_scan_fwd / {scan_bwd} lstm_scan_bwd launches for {steps} "
            f"train steps and {forwards} forwards: a site or a layer "
            "bypassed its kernel")
    # the step time at B=64, one pass over the corpus from the epoch's state
    loader = cli._build_loader(cfg, vocab, cfg.train_scp_path,
                               cfg.train_lab_path, cfg.train_trans_path,
                               train=True)
    acc = torch.zeros(4, device="cuda")
    secs = []
    for padded, valid in (pad_batch_to(b, BATCH) for b in loader):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = trainer.train_step(trainer.batch_arrays(padded, valid), acc)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    log(f"[train-bf16] step time at B={BATCH}: median "
        f"{statistics.median(secs) * 1e3:.2f} ms over {len(secs)} steps "
        f"(min {min(secs) * 1e3:.2f}, max {max(secs) * 1e3:.2f}) ({card})")
    batches = [trainer.batch_arrays(padded, valid) for padded, valid in
               (pad_batch_to(b, BATCH) for b in loader)]
    turns = {f"B={BATCH}": text_turns(torch, trainer, batches, "train-bf16",
                                      card)}
    turns["B=512 x 160"] = bench_cell_fused_step(torch, trainer.model_cfg,
                                                 card)
    return {"fused_dropout": drops, "lstm_fwd": fwd, "lstm_bwd": bwd,
            "text_turns": turns}


def bench_cell_fused_step(torch, model_cfg, card: str) -> dict:
    """Trainer steps of the full-width bfloat16 model with fused dropout
    at bench.py's cell (B=512 x 160 frames, T'=80, 48 canonical phones, the
    benchmark's seeded batch), the largest batch a train step gives the
    dropout kernel: each step's loss finite, fused_dropout 12 counts,
    lstm_bwd one a layer and lstm_scan_fwd / lstm_scan_bwd one a step;
    then the loss on the CTC kernels and the text BiLSTM on the scan
    kernels, each against what it replaced, in turns; -> text_turns'."""
    from mdd_tpu_torch import bench
    from mdd_tpu_torch.ops.dropout_cuda import fused_dropout_kernel
    from mdd_tpu_torch.ops.lstm_cuda import (
        lstm_bwd_kernel,
        lstm_scan_bwd_kernel,
        lstm_scan_fwd_kernel,
    )
    from mdd_tpu_torch.train.loop import Trainer

    if not model_cfg.use_fused_dropout:
        raise AssertionError("the bench-cell step needs use_fused_dropout")
    tr = Trainer(model_cfg, device="cuda", device_frontend=False)
    arrays = tr.batch_arrays(bench.train_batch(
        model_cfg, bench.BATCH, bench.FRAMES, bench.LABEL_LEN))
    kernels = (fused_dropout_kernel, lstm_bwd_kernel, lstm_scan_fwd_kernel,
               lstm_scan_bwd_kernel)
    before = [k.launches for k in kernels]
    losses, secs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        acc = tr.train_step(arrays, torch.zeros(4, device="cuda"))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(acc[0].item())
    drops, bwd, scan_fwd, scan_bwd = (k.launches - b
                                      for k, b in zip(kernels, before))
    log(f"[train-bf16] bench.py's cell with fused dropout, B={bench.BATCH} "
        f"x {bench.FRAMES} frames (T'={model_cfg.output_frames(bench.FRAMES)}"
        f", L={bench.LABEL_LEN}), bfloat16: step losses "
        f"{' / '.join(f'{v:.4f}' for v in losses)}; fused_dropout {drops}, "
        f"lstm_bwd {bwd}, lstm_scan_fwd {scan_fwd}, lstm_scan_bwd "
        f"{scan_bwd} launches over {len(secs)} steps; step time "
        f"{' / '.join(f'{v * 1e3:.1f}' for v in secs)} ms ({card})")
    if not all(math.isfinite(v) and 0 < v < 1e29 for v in losses):
        raise AssertionError(f"bench-cell fused-dropout step losses {losses}")
    if (drops != 12 * len(secs) or bwd != model_cfg.rnn_layers * len(secs)
            or scan_fwd != len(secs) or scan_bwd != len(secs)):
        raise AssertionError(
            f"{drops} fused_dropout / {bwd} lstm_bwd / {scan_fwd} "
            f"lstm_scan_fwd / {scan_bwd} lstm_scan_bwd launches for "
            f"{len(secs)} steps of {model_cfg.rnn_layers} layers")
    # the loss on the CTC kernels against F.ctc_loss at this cell, in turns
    from mdd_tpu_torch.train import loop

    kernel_ctc = loop.ctc_loss
    medians = {"kernels": [], "F.ctc_loss": []}
    try:
        for which in ("kernels", "F.ctc_loss", "F.ctc_loss", "kernels"):
            loop.ctc_loss = (kernel_ctc if which == "kernels"
                             else library_ctc_loss)
            turn = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.train_step(arrays, torch.zeros(4, device="cuda"))
                torch.cuda.synchronize()
                turn.append(time.perf_counter() - t0)
            medians[which].append(round(statistics.median(turn) * 1e3, 2))
    finally:
        loop.ctc_loss = kernel_ctc
    log(f"[train-bf16] bench.py's cell: step median with the loss on the "
        f"CTC kernels {medians['kernels']} ms, on F.ctc_loss "
        f"{medians['F.ctc_loss']} ms (in turns, 3 steps each) ({card})")
    # the text BiLSTM on the scan kernels against the plain loop, in turns
    return text_turns(torch, tr, [arrays] * 3, "train-bf16", card)


def write_eval_yaml(conf: str, name: str, split: tuple, lm: str,
                    exp_name: str = "smoke_fused", **overrides) -> str:
    """The train YAML with the `exp_name` experiment, `split` as test
    split, and beam + LM decoding; `overrides` replace fields."""
    fields = {
        "exp_name": exp_name, "test_scp_path": split[0],
        "test_lab_path": split[1], "test_trans_path": split[2],
        "decode_type": "Beam", "beam_width": 10, "lm_alpha": 0.5,
        "lm_path": lm, **overrides}
    lines = [l for l in Path(conf).read_text().splitlines()
             if l.split(":")[0] not in fields]
    path = WORK / f"{name}.yaml"
    path.write_text("\n".join(lines) + "\n" + "".join(
        f"{k}: {json.dumps(v)}\n" for k, v in fields.items()))
    return str(path)


def parse_report(text: str) -> dict:
    """The all-languages block of format_mdd_report."""
    block = text.split(" mandarin ")[0]
    grab = lambda pat: re.search(pat, block).groups()
    total, parts = map(int, grab(r"total :  (\d+) (\d+)"))
    out = {"errors": int(grab(r"total_error: (\d+)")[0]),
           "tokens": int(grab(r"total_phoneme: (\d+)")[0]),
           "per": float(grab(r"Phoneme error rate on test set: (\S+)")[0]),
           "total": total, "parts": parts}
    for key in ("TA", "FR", "FA", "TR"):
        out[key] = int(grab(rf"{key} :  (\d+)")[0])
    out["f1"] = float(grab(r"F1 score : (\S+)")[0])
    out["utts"] = int(re.search(r"time used for decode (\d+) sentences",
                                text).group(1))
    if not all(math.isfinite(v) for v in out.values()):
        raise AssertionError(f"report holds a value that is not finite: {out}")
    return out


def phase_evaluate(torch, conf: str, train: tuple, dev: tuple,
                   card: str) -> tuple:
    """The evaluation path; -> (lstm_fwd launches, the YAML)."""
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.decode.arpa import ArpaBigramLM
    from mdd_tpu_torch.decode.beam import BeamSearchDecoder
    from mdd_tpu_torch.evals.evaluate import EvalSession
    from mdd_tpu_torch.evals.wer import read_trn
    from mdd_tpu_torch.ops.lstm_cuda import lstm_fwd_kernel
    from mdd_tpu_torch.utils.config import load_config

    lm = str(WORK / "lm.arpa")
    log("[evaluate] " + run_cli(["train-lm", "--phn-text", train[1],
                                 "--out", lm]).strip())
    yaml_path = write_eval_yaml(conf, "eval_dev", dev, lm)
    kinds = (("beam", []), ("beam_no_lm", ["--lm-alpha", "0"]),
             ("greedy", ["--decode-type", "Greedy"]))
    dumps = {k: WORK / f"dump_{k}" for k, _ in kinds}
    lstm_fwd_kernel.launches = 0
    zero_path_launches()
    reports, wall = {}, {}
    for kind, flags in kinds:
        t0 = time.perf_counter()
        text = run_cli(["evaluate", "--conf", yaml_path, "--device", ONE_CARD,
                        "--dump-dir", str(dumps[kind])] + flags)
        wall[kind] = time.perf_counter() - t0
        reports[kind] = parse_report(text)
    launches = lstm_fwd_kernel.launches
    new = record_path_launches("evaluate")
    forwards = len(kinds) * -(-DEV_UTTS // BATCH)
    # a beam launch a batch of the two beam passes, none for greedy
    if new != {"greedy_wer": 0, "ctc_beam": 2 * -(-DEV_UTTS // BATCH),
               "ctc_alpha": 0, "ctc_beta_grad": 0, "lstm_scan_fwd": 0,
               "lstm_scan_bwd": 0}:
        raise AssertionError(f"{new} over the three passes: the beam "
                             "bypassed its kernel")
    result = run_cli(["mdd-result", "--ref", str(dumps["beam"] / "transcribe.log"),
                      "--human", str(dumps["beam"] / "human_seq.log"),
                      "--hyp", str(dumps["beam"] / "decode_seq.log"),
                      "--detail-dir", str(WORK / "detail")])
    wer = re.search(r"%WER (\S+) \[ (\d+) / (\d+), (\d+) ins, (\d+) del, "
                    r"(\d+) sub \]", result)
    recall = float(re.search(r"Recall: (\S+)", result).group(1))
    canon = sum(len(v) for v in read_trn(
        str(dumps["beam"] / "transcribe.log")).values())
    beam, greedy = reports["beam"], reports["greedy"]
    for kind, r in reports.items():
        log(f"[evaluate] {kind}: PER {r['per']:.4f} ({r['errors']} / "
            f"{r['tokens']}), TA {r['TA']} FR {r['FR']} FA {r['FA']} TR "
            f"{r['TR']} over {r['total']} canonical phones, F1 {r['f1']:.2f}; "
            f"{r['utts']} utterances in {wall[kind]:.2f} s, set-up included "
            f"({card})")
    log(f"[evaluate] mdd-result on the beam + LM dumps: {wer.group(0)}; recall "
        f"{recall:.4f}; lstm_fwd launches {launches} over {forwards} "
        f"forwards; ctc_beam launches {new['ctc_beam']}")
    for r in reports.values():
        if (r["utts"] != DEV_UTTS or r["total"] != canon
                or r["parts"] != r["TA"] + r["FR"] + r["FA"] + r["TR"]
                or r["parts"] < r["total"] or r["tokens"] <= 0):
            raise AssertionError(f"report does not add up: {r}, {canon} "
                                 "canonical phones in the dump")
    if (int(wer.group(2)), int(wer.group(3))) != (beam["errors"],
                                                  beam["tokens"]):
        raise AssertionError("mdd-result's PER is not evaluate's: "
                             f"{wer.group(0)} vs {beam}")
    if not math.isfinite(recall) or launches != lstm_per_pass() * forwards:
        raise AssertionError(f"{launches} lstm_fwd launches for {forwards} "
                             "forwards, or recall not finite")
    for kind in ("beam", "beam_no_lm"):
        if abs(reports[kind]["per"] - greedy["per"]) > PER_GAP:
            raise AssertionError(
                f"{kind} PER {reports[kind]['per']} and greedy PER "
                f"{greedy['per']} are over {PER_GAP} apart")

    # one batch of this model's log-probs: device beam vs host beam
    cfg = load_config(yaml_path)
    vocab = Vocab.from_units_file(cfg.vocab_file)
    state, model_cfg = cli._load_best(cfg, None)
    session = EvalSession(
        model_cfg, state, vocab, decode_type="Beam", beam_width=10,
        lm_path=lm, lm_alpha=0.5, device="cuda", device_frontend=True,
        left_ctx=cfg.left_ctx, right_ctx=cfg.right_ctx,
        n_skip_frame=cfg.n_skip_frame, n_downsample=cfg.n_downsample)
    batch = next(iter(cli._build_loader(cfg, vocab, *dev, train=False)))
    log_probs, frames = session._forward(*session.stage_batch(batch)[1])
    lp = log_probs.transpose(0, 1)
    on_card = session.beam.decode_log(lp, frames.tolist())
    on_cpu = session.beam.decode_log(lp.cpu(), frames.tolist())

    class TotalLM(ArpaBigramLM):
        """bi_prob for every unit: a word the LM never saw ("err" is in
        the inventory, not in the corpus) gets the -1e30 that dense_matrix
        gives the device beam, where the host beam would raise."""

        def bi_prob(self, w1: str, w2: str) -> float:
            known = all(w in self.unigram for w in (w1 or self.start,
                                                    w2 or self.end))
            return super().bi_prob(w1, w2) if known else -1e30

    host = BeamSearchDecoder(vocab.index2word, beam_width=10,
                             lm=TotalLM(lm), lm_alpha=0.5)
    t0 = time.perf_counter()
    want = host.decode(torch.exp(lp).double().cpu().numpy(), frames.tolist())
    host_s = time.perf_counter() - t0
    share = sum(a == b for a, b in zip(on_card, want)) / len(want)
    same_cpu = sum(a == b for a, b in zip(on_card, on_cpu)) / len(want)
    log(f"[evaluate] device beam vs host beam on {len(want)} utterances of "
        f"the model's log-probs (T' up to {int(frames.max())}): "
        f"{100 * share:.1f}% identical (bar {100 * BEAM_MATCH:.0f}%); the "
        f"same search on the CPU: {100 * same_cpu:.1f}% identical; host "
        f"beam {host_s:.1f} s")
    if share < BEAM_MATCH or same_cpu < BEAM_MATCH:
        raise AssertionError("the device beam disagrees with the host beam")
    return launches, yaml_path


@contextlib.contextmanager
def plain_beam():
    """decode/beam_jit's dispatcher sends every tensor, CUDA ones too, to
    the plain frame loop while the block runs (for timing the two side by
    side)."""
    from mdd_tpu_torch.decode import beam_jit

    dispatch = beam_jit.beam_search
    beam_jit.beam_search = beam_jit.beam_search_batch
    try:
        yield
    finally:
        beam_jit.beam_search = dispatch


def phase_profile_evaluate(torch, conf: str, train: tuple, card: str) -> None:
    """Throughput and device busy share of evaluate_model (the beam on its
    kernel and on the plain loop, in turns), and the beam alone three ways
    in turns."""
    from torch.profiler import ProfilerActivity, profile

    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.decode.beam_jit import BatchedBeamDecoder
    from mdd_tpu_torch.evals.evaluate import EvalSession, evaluate_model
    from mdd_tpu_torch.ops.beam_cuda import ctc_beam_kernel
    from mdd_tpu_torch.utils.config import load_config

    lm = str(WORK / "lm.arpa")
    cfg = load_config(write_eval_yaml(conf, "eval_train", train, lm))
    vocab = Vocab.from_units_file(cfg.vocab_file)
    state, model_cfg = cli._load_best(cfg, None)
    quiet = lambda *_: None

    def rate(session) -> tuple:
        loader = cli._build_loader(cfg, vocab, *train, train=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = evaluate_model(session, loader, log=quiet)
        torch.cuda.synchronize()
        return rep.n_utts / (time.perf_counter() - t0), rep

    for kind in ("Beam", "Greedy"):
        session = EvalSession(
            model_cfg, state, vocab, decode_type=kind, beam_width=10,
            lm_path=lm, lm_alpha=0.5, device="cuda", device_frontend=True,
            left_ctx=cfg.left_ctx, right_ctx=cfg.right_ctx,
            n_skip_frame=cfg.n_skip_frame, n_downsample=cfg.n_downsample)
        if kind == "Greedy":
            rates = [rate(session)[0] for _ in range(2)]
            rep = rate(session)[1]
            log(f"[profile-evaluate] evaluate_model, Greedy, {rep.n_utts} "
                f"utterances in batches of {BATCH}: {rates[0]:.1f} then "
                f"{rates[1]:.1f} utterances per second; PER {rep.per:.2f} "
                f"({card})")
            continue
        rates, pers = {"kernel": [], "plain": []}, {}
        for which in ("kernel", "plain", "plain", "kernel"):
            with (plain_beam() if which == "plain"
                  else contextlib.nullcontext()):
                r, rep = rate(session)
            rates[which].append(round(r, 1))
            pers[which] = rep.per
        log(f"[profile-evaluate] evaluate_model, beam 10 + LM 0.5, "
            f"{rep.n_utts} utterances in batches of {BATCH}, utterances per "
            f"second in turns: the beam kernel {rates['kernel']}, the plain "
            f"frame loop {rates['plain']}; PER {pers['kernel']:.2f} / "
            f"{pers['plain']:.2f} ({card})")
        if pers["kernel"] != pers["plain"]:
            log("[profile-evaluate]   the two beams' PERs differ")
        loader = cli._build_loader(cfg, vocab, *train, train=False)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            evaluate_model(session, loader, log=quiet)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        report_profile(prof, wall_us, "profile-evaluate",
                       f"one beam pass over {rep.n_utts} utterances "
                       "(profiler on)", card)

    # the beam alone at the evaluation shape: decode_log as evaluate calls
    # it (to host sequences), the kernel's launch alone, decode_log on the
    # plain loop
    t_out, n_class, width = 110, len(UNITS) + 2, 10
    g = torch.Generator().manual_seed(SEED + 5)
    logits = torch.randn((BATCH, t_out, n_class), generator=g)
    logits[:, :, 0] += 1.5
    lp = torch.log_softmax(logits, dim=-1).cuda()
    beam = BatchedBeamDecoder(vocab.index2word, beam_width=width,
                              device="cuda")
    lengths = [t_out] * BATCH
    dev_lengths = torch.full((BATCH,), t_out, dtype=torch.int64,
                             device="cuda")
    decode = lambda: beam.decode_log(lp, lengths)
    launch = lambda: ctc_beam_kernel(lp, dev_lengths, beam.lm_matrix, width,
                                     0, 0.1)
    ways = {"decode_log": [], "kernel": [], "plain": []}
    for turn in ("kernel", "plain", "plain", "kernel"):
        if turn == "kernel":
            ways["decode_log"].append(host_ms(decode, 20))
            ways["kernel"].append(cuda_ms(launch, 50))
        else:
            with plain_beam():
                ways["plain"].append(host_ms(decode, 3))
    with plain_beam(), profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        plain_us = (time.perf_counter() - t0) * 1e6
    ops = sum(e.count for e in device_ops(prof))
    ms = min(ways["decode_log"])
    log(f"[timing] device beam, B={BATCH} T'={t_out} K={width} C={n_class}, "
        f"in turns: decode_log on the kernel {ways['decode_log']} ms, the "
        f"kernel's launch {ways['kernel']} ms (CUDA events), decode_log on "
        f"the plain loop {ways['plain']} ms; {ms / t_out:.5f} ms a frame, "
        f"{BATCH / ms * 1e3:.0f} utterances per second on the kernel; the "
        f"plain loop {ops} device ops a batch, {ops / t_out:.1f} a frame "
        f"({card})")
    report_profile(prof, plain_us, "timing",
                   "one beam batch on the plain loop (profiler on)", card)


def write_hard_corpus() -> dict:
    """TRAIN_UTTS / DEV_UTTS / DEV_UTTS utterances of the hard profile
    (16-40 phones, the recovered 41-unit inventory of mdd_tpu's quality
    runs) through the port's corpus tool; -> {split: (scp, lab, trans)}."""
    from mdd_tpu_torch.tools import synthetic_corpus

    root = WORK / "hard"
    with contextlib.redirect_stdout(io.StringIO()):
        synthetic_corpus.cli([str(root), str(TRAIN_UTTS), str(DEV_UTTS),
                              str(DEV_UTTS), "--profile", "hard",
                              "--min-phones", "16", "--max-phones", "40",
                              "--units", str(HARD_UNITS)])
    return {split: tuple(str(root / f"{split}{x}") for x in (
        ".scp", "_phn_text", "_transcript_phn_text"))
        for split in ("train", "dev", "test")}


def wire_bytes(batch) -> int:
    """Host -> device bytes of one step's batch: every host array the step
    moves (the CachedBatch's index and label arrays, or the streaming
    batch's features and labels) plus the validity mask."""
    import numpy as np

    if hasattr(batch, "idx"):
        arrays = (batch.idx, batch.lengths, batch.aug, batch.targets,
                  batch.target_sizes, batch.trans, batch.trans_sizes,
                  batch.valid)
        return sum(a.nbytes for a in arrays)
    inputs = batch.inputs
    return (inputs.numel() * inputs.element_size() + sum(
        a.nbytes for a in (batch.input_fracs, batch.targets,
                           batch.target_sizes, batch.trans,
                           batch.trans_sizes)) + batch.size)


def phase_train_cached(torch, card: str) -> dict:
    """The training path on the device-resident corpus: a hard-profile
    corpus from the port's tool, `train` with device_cache: true for 2
    epochs and `--resume` for a third, in-process; one CachedBatch against
    SpeechDataset.load_item bit for bit; the resumed epoch's batches
    against a fresh loader's at set_epoch(2); then cached and streaming
    step medians in turns.  -> launch counts and the YAML."""
    import numpy as np

    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.dataset import pad_batch_to
    from mdd_tpu_torch.data.device_cache import CachedLoader
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.ops.lstm_cuda import lstm_bwd_kernel, lstm_fwd_kernel
    from mdd_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    corpus = write_hard_corpus()
    gen_s = time.perf_counter() - t0
    confs = [write_train_yaml(
        corpus["train"], corpus["dev"], e, exp_name="smoke_cached",
        vocab_file=str(HARD_UNITS), device_cache=True, time_quantum=128,
        label_quantum=32) for e in (2, 3)]
    cfg = load_config(confs[1])
    vocab = Vocab.from_units_file(cfg.vocab_file)
    fresh = {train: cli._build_loader(cfg, vocab, *corpus[name], train=train,
                                      device="cuda")
             for name, train in (("train", True), ("dev", False))}
    steps_epoch, dev_epoch = len(fresh[True]), len(fresh[False])

    # the batches the train loader made in each epoch, as run
    made, make_batch = {}, CachedLoader._make_batch

    def record(self, bucket, chunk, epoch):
        batch = make_batch(self, bucket, chunk, epoch)
        if self.shuffle:
            made.setdefault(epoch, []).append(batch)
        return batch

    CachedLoader._make_batch = record
    lstm_fwd_kernel.launches = lstm_bwd_kernel.launches = 0
    zero_path_launches()
    t0 = time.perf_counter()
    try:
        out = run_cli(["train", "--conf", confs[0], "--device", "cuda"])
        out += run_cli(["train", "--conf", confs[1], "--device", "cuda",
                        "--resume"])
    finally:
        CachedLoader._make_batch = make_batch
    wall = time.perf_counter() - t0
    fwd, bwd = lstm_fwd_kernel.launches, lstm_bwd_kernel.launches
    record_path_launches("train-cached")
    for line in out.splitlines():
        if "done" in line or "resumed" in line or "best dev" in line:
            log(f"[train-cached]   {line}")
    steps = 3 * steps_epoch
    forwards = steps + 3 * dev_epoch
    first = float(re.search(r"Epoch = 1, step = 1, total_loss = (\S+?),",
                            out).group(1))
    epochs = [float(v) for v in
              re.findall(r"Train done, total_loss: (\S+?),", out)]
    cache = fresh[True].cache
    log(f"[train-cached] hard corpus {TRAIN_UTTS}/{DEV_UTTS}/{DEV_UTTS} in "
        f"{gen_s:.1f} s; cache {cache.bytes / 2**20:.1f} MiB in buckets "
        f"{sorted(cache.buckets)} raw frames; 3 epochs ({steps_epoch} steps "
        f"each) at B={BATCH} in {wall:.1f} s, set-up included; first step "
        f"loss {first:.4f}, epoch losses {epochs}; lstm_fwd launches {fwd} "
        f"over {forwards} forwards, lstm_bwd {bwd} over {steps} steps")
    if len(epochs) != 3 or not all(math.isfinite(v) for v in
                                   epochs + [first]):
        raise AssertionError(f"losses missing or not finite: {epochs}")
    if not (epochs[-1] < epochs[0] < first):
        raise AssertionError(f"the loss did not fall: {first}, {epochs}")
    if "resumed from epoch 2" not in out:
        raise AssertionError("the third epoch did not resume from epoch 2")
    if bwd != lstm_per_pass() * steps or fwd < lstm_per_pass() * forwards:
        raise AssertionError(f"{fwd} forward / {bwd} backward launches for "
                             f"{forwards} forwards / {steps} train steps: a "
                             "layer bypassed the kernels")

    # the resumed epoch's batches = a fresh loader's at set_epoch(2)
    loader = fresh[True]
    loader.set_epoch(2)
    want = list(loader)
    got = made.get(2, [])
    if len(got) != len(want) or not all(
            a.bucket == b.bucket and a.utt_ids == b.utt_ids and all(
                np.array_equal(getattr(a, f), getattr(b, f)) for f in (
                    "idx", "lengths", "aug", "targets", "trans", "valid"))
            for a, b in zip(got, want)):
        raise AssertionError("the resumed epoch's batches are not those of "
                             "a fresh loader at set_epoch(2)")

    # one CachedBatch, gathered and masked on the card, bit for bit
    trainer = cli.build_trainer(cfg, vocab, "cuda")
    trainer.restore(cfg.checkpoint_dir, cfg.exp_name, "latest")
    batch = want[0]
    inputs = trainer.cached_arrays(cache, batch)[0].cpu()
    ds = loader.ds
    index = {it[0]: i for i, it in enumerate(ds.items)}
    for k in np.flatnonzero(batch.valid):
        i = index[batch.utt_ids[k]]
        feat, _, trans, _ = ds.load_item(
            i, np.random.default_rng((loader.seed + 2, i)))
        host = torch.zeros((batch.bucket, feat.shape[1]), dtype=inputs.dtype)
        host[:feat.shape[0]] = torch.from_numpy(feat)
        if not (torch.equal(inputs[k].view(torch.int16),
                            host.view(torch.int16))
                and list(batch.trans[k][:batch.trans_sizes[k]]) == trans):
            raise AssertionError(f"cached item {batch.utt_ids[k]} differs "
                                 "from SpeechDataset.load_item")
    log(f"[train-cached] the resumed epoch's {len(got)} batches equal a "
        f"fresh loader's at set_epoch(2); {int(batch.valid.sum())} items of "
        f"a {inputs.dtype} CachedBatch (bucket {batch.bucket}) equal "
        "SpeechDataset.load_item bit for bit")

    # step medians, cached and streaming in turns, a turn an epoch
    stream_cfg = dataclasses.replace(cfg, device_cache=False)
    loaders = {"cached": loader, "streaming": cli._build_loader(
        stream_cfg, vocab, *corpus["train"], train=True)}
    acc = torch.zeros(4, device="cuda")
    medians = {"cached": [], "streaming": []}
    sent = {}
    for name in ("cached", "streaming", "streaming", "cached"):
        secs, sizes, it = [], [], iter(loaders[name])
        while True:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            if name == "cached":
                arrays = trainer.cached_arrays(cache, batch)
            else:
                batch, valid = pad_batch_to(batch, BATCH)
                arrays = trainer.batch_arrays(batch, valid)
            acc = trainer.train_step(arrays, acc)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            sizes.append(wire_bytes(batch))
        medians[name].append(statistics.median(secs) * 1e3)
        sent[name] = sizes
    log(f"[train-cached] step time at B={BATCH} on the hard corpus (the "
        f"next batch, its copy and the step, to a synchronize), median of an "
        f"epoch, in turns: cached {medians['cached'][0]:.2f} / "
        f"{medians['cached'][1]:.2f} ms, streaming "
        f"{medians['streaming'][0]:.2f} / {medians['streaming'][1]:.2f} ms; "
        f"host -> device bytes a step: cached {sent['cached'][0]:,} (mean "
        f"{statistics.mean(sent['cached']):,.0f}), streaming "
        f"{sent['streaming'][0]:,} (mean "
        f"{statistics.mean(sent['streaming']):,.0f}) ({card})")
    return {"lstm_fwd": fwd, "lstm_bwd": bwd, "conf": confs[1],
            "corpus": corpus}


def padded_widths(loader) -> dict:
    """utt -> (feature width, canonical-transcript width) of its batch."""
    out = {}
    for b in loader:
        width = b.bucket if hasattr(b, "bucket") else b.inputs.shape[1]
        for utt in b.utt_ids:
            out.setdefault(utt, (width, b.trans.shape[1]))
    return out


def phase_evaluate_cached(torch, cached: dict, card: str) -> int:
    """`evaluate --cached` against the streaming `evaluate` on the hard
    test split with train-cached's `best` (beam 10 + the corpus LM at
    alpha 0.5): at batch size 1, where both pad each utterance alike,
    report and dump lines equal; at B=64 the utterances padded alike
    decode alike.  -> lstm_fwd launches of the cached runs."""
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.ops.lstm_cuda import lstm_fwd_kernel
    from mdd_tpu_torch.utils.config import load_config

    corpus = cached["corpus"]
    lm = str(WORK / "hard_lm.arpa")
    run_cli(["train-lm", "--phn-text", corpus["train"][1], "--out", lm])
    launches, results = 0, {}
    for b in (1, BATCH):
        conf = write_eval_yaml(cached["conf"], f"eval_cached_b{b}",
                               corpus["test"], lm, exp_name="smoke_cached",
                               batch_size=b)
        for flags in ([], ["--cached"]):
            dump = WORK / f"dump_cached_b{b}_{len(flags)}"
            lstm_fwd_kernel.launches = 0
            zero_path_launches()
            t0 = time.perf_counter()
            text = run_cli(["evaluate", "--conf", conf, "--device", ONE_CARD,
                            "--dump-dir", str(dump)] + flags)
            wall = time.perf_counter() - t0
            record_path_launches("evaluate-cached")
            if flags:
                launches += lstm_fwd_kernel.launches
            report = parse_report(text)
            lines = {f.name: dict(l.split(" ", 1) for l in
                                  f.read_text().splitlines())
                     for f in sorted(dump.iterdir())}
            results[b, bool(flags)] = report, lines
            log(f"[evaluate-cached] B={b} {'cached' if flags else 'streaming'}"
                f": PER {report['per']:.4f}, TA {report['TA']} FR "
                f"{report['FR']} FA {report['FA']} TR {report['TR']}, F1 "
                f"{report['f1']:.2f}; {report['utts']} utterances in "
                f"{wall:.2f} s, set-up included ({card})")
    (r_s, l_s), (r_c, l_c) = results[1, False], results[1, True]
    if r_s != r_c or l_s != l_c:
        raise AssertionError(f"evaluate --cached at B=1 {r_c} differs from "
                             f"the streaming evaluate {r_s}")
    cfg = load_config(conf)                  # B=64's
    vocab = Vocab.from_units_file(cfg.vocab_file)
    widths = {}
    for cache_on in (False, True):
        cfg.device_cache = cache_on
        loader = cli._build_loader(cfg, vocab, *corpus["test"], train=False,
                                   device="cuda")
        widths[cache_on] = padded_widths(loader)
    forwards = DEV_UTTS + len(loader)
    alike = [u for u in widths[False] if widths[False][u] == widths[True][u]]
    (r_s, l_s), (r_c, l_c) = results[BATCH, False], results[BATCH, True]
    differ = [u for u in alike if l_s["decode_seq.log"][u]
              != l_c["decode_seq.log"][u]]
    moved = sum(l_s["decode_seq.log"][u] != l_c["decode_seq.log"][u]
                for u in l_s["decode_seq.log"])
    log(f"[evaluate-cached] B=1: cached report and dumps equal the streaming "
        f"ones; B={BATCH}: {len(alike)} of {len(widths[False])} utterances "
        f"padded alike, {len(differ)} of them decoded otherwise; "
        f"{moved} decodes moved in all, PER {r_s['per']:.4f} streaming vs "
        f"{r_c['per']:.4f} cached; lstm_fwd launches {launches} over the "
        f"cached runs' {forwards} forwards")
    if differ or (r_s["tokens"], r_s["total"]) != (r_c["tokens"],
                                                    r_c["total"]):
        raise AssertionError(f"utterances padded alike decode otherwise: "
                             f"{differ}")
    if launches != lstm_per_pass() * forwards:
        raise AssertionError(f"{launches} lstm_fwd launches in the cached "
                             f"evaluations' {forwards} forwards: a layer "
                             "bypassed the kernel")
    return launches


def phase_timing_dropout(torch, card: str) -> dict:
    """fused_dropout at the 3 sites of a train step, float32 and bfloat16
    (ops/dropout_time.py): a call (CUDA events over back-to-back calls,
    inputs rotating past L2) and the kernel's device time (torch.profiler),
    each the mean of two turns, beside the bound, the plain version and
    F.dropout; -> {site: {dtype: numbers}}."""
    from mdd_tpu_torch.ops.dropout_cuda import (
        SITES,
        bound_ms,
        fused_dropout_kernel,
    )
    from mdd_tpu_torch.ops.dropout_time import time_site

    out = {}
    for name, shape in SITES.items():
        n = math.prod(shape)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            times = time_site(name, dt, {"fused_dropout": fused_dropout_kernel},
                              50, plain_iters=3)
            (calls, kern, equal), (lib_calls, lib_kern, _) = (
                times["fused_dropout"], times["F.dropout"])
            if not equal:
                raise AssertionError(f"fused_dropout {dtype} at {name} "
                                     "differs from its plain version")
            bnd, bound_by = bound_ms(n, dt)
            entry = {"ms": statistics.mean(calls),
                     "kernel_ms": statistics.mean(kern),
                     "plain_ms": times["plain"][0][0], "bound_ms": bnd,
                     "bound_by": bound_by,
                     "library_ms": statistics.mean(lib_calls),
                     "library_kernel_ms": statistics.mean(lib_kern)}
            out.setdefault(name, {})[dtype] = entry
            log(f"[timing] fused_dropout {dtype} {name} {tuple(shape)} "
                f"({n / 1e6:.1f} M elements): a call "
                f"{' / '.join(f'{v:.4f}' for v in calls)} ms, kernel "
                f"{' / '.join(f'{v:.4f}' for v in kern)} ms "
                f"({100 * bnd / entry['kernel_ms']:.0f}% of its bound "
                f"{bnd:.4f} ms, {bound_by}); plain fused_dropout_reference "
                f"{entry['plain_ms']:.2f} ms; F.dropout a call "
                f"{' / '.join(f'{v:.4f}' for v in lib_calls)} ms, kernel "
                f"{' / '.join(f'{v:.4f}' for v in lib_kern)} ms ({card})")
            torch.cuda.empty_cache()
    return out


DDP_TIMEOUT_S = 420   # one rank's process, set-up included
DDP_TRAIN_RTOL = 1e-4  # 2 ranks x 32 vs 1 x 64: every logged train loss
DDP_DEV_RTOL = 3e-4    # the dev loss after the epoch's 8 Adam steps.
# Sound runs on an H100 read up to 9.8e-5 (PERF.md §6) while the conv
# biases, which feed a train-mode BatchNorm, took Adam steps of about
# lr * sign(rounding) that differed between the two runs; their gradient
# is now exactly 0 (ROADMAP §3 item 10)

# Each rank is `python -c RANK_BOOT <result> <cli args>`: the port's CLI
# entry point, with the launch counters set to 0 just before it, each
# train step and gradient all-reduce timed to a synchronize, every
# accumulator read (the logged losses at full precision), the evaluation
# forwards and wall time and the rank's group (backend, size, card)
# recorded, and `use_fused_dropout` passed to
# cli.build_trainer where SMOKE_FUSED is set (no YAML key sets it, in
# mdd_tpu either).
RANK_BOOT = r"""
import json, os, sys, time
sys.path.insert(0, os.environ["SMOKE_ROOT"])
import torch
from mdd_tpu_torch import cli
from mdd_tpu_torch.evals import evaluate
from mdd_tpu_torch.ops.dropout_cuda import fused_dropout_kernel
from mdd_tpu_torch.ops.lstm_cuda import lstm_bwd_kernel, lstm_fwd_kernel
from mdd_tpu_torch.train.loop import Trainer

rec = {"steps": [], "reduces": [], "fetches": [], "eval_steps": 0,
       "forwards": 0}
if os.environ.get("SMOKE_FUSED"):
    build = cli.build_trainer
    cli.build_trainer = lambda *a, **k: build(*a, use_fused_dropout=True,
                                              **k)

def group():
    import torch.distributed as dist
    rec["backend"] = dist.get_backend() if dist.is_initialized() else "none"
    rec["world"] = dist.get_world_size() if dist.is_initialized() else 1
    rec["card"] = torch.cuda.current_device()

def timed(fn, key):
    def wrapped(self, *a, **k):
        group()
        rec["grad_bytes"] = 4 * sum(p.numel()
                                    for p in self.model.parameters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(self, *a, **k)
        torch.cuda.synchronize()
        rec[key].append(time.perf_counter() - t0)
        return out
    return wrapped

Trainer.train_step = timed(Trainer.train_step, "steps")
Trainer.all_reduce_gradients = timed(Trainer.all_reduce_gradients,
                                     "reduces")
fetch, eval_step, run_eval = (Trainer._fetch, Trainer.eval_step,
                              evaluate.evaluate_model)

def fetch_rec(self, acc):
    out = fetch(self, acc)
    rec["fetches"].append(list(out))
    return out

def eval_rec(self, *a):
    rec["eval_steps"] += 1
    return eval_step(self, *a)

def forward_rec(self, *a):
    rec["forwards"] += 1
    return forward(self, *a)

def run_eval_rec(*a, **k):
    group()
    t0 = time.perf_counter()
    rep = run_eval(*a, **k)
    torch.cuda.synchronize()
    rec["eval_s"] = time.perf_counter() - t0
    return rep

Trainer._fetch, Trainer.eval_step = fetch_rec, eval_rec
evaluate.evaluate_model = run_eval_rec
forward = evaluate.EvalSession._forward
evaluate.EvalSession._forward = forward_rec
kernels = {"lstm_fwd": lstm_fwd_kernel, "lstm_bwd": lstm_bwd_kernel,
           "fused_dropout": fused_dropout_kernel}
for k in kernels.values():
    k.launches = 0
rc = cli.main(sys.argv[2:])
rec["launches"] = {n: k.launches for n, k in kernels.items()}
with open(sys.argv[1].replace("RANK", os.environ.get("RANK", "0")), "w") as f:
    json.dump(rec, f)
sys.exit(rc)
"""


def run_ranks(tag: str, n: int, args: list, env: dict = None) -> list:
    """`args` of the port's CLI as `n` ranks (torchrun's variables, a free
    port, `--distributed`), or as one plain process (n = 0); -> each
    process's (log text, record).  A rank that fails or outlives
    DDP_TIMEOUT_S fails the phase; every process is ended."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    for rank in range(max(n, 1)):
        penv = {k: v for k, v in os.environ.items()
                if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                             "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                             "MASTER_PORT")}
        penv.update(SMOKE_ROOT=str(ROOT), **(env or {}))
        argv = list(args)
        if n:
            penv.update(RANK=str(rank), WORLD_SIZE=str(n),
                        LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n),
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            argv.append("--distributed")
        logs.append(WORK / f"{tag}_rank{rank}.log")
        with open(logs[-1], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_BOOT,
                 str(WORK / f"{tag}_RANK.json")] + argv,
                cwd=ROOT, env=penv, stdout=out, stderr=subprocess.STDOUT))
    try:
        deadline = time.monotonic() + DDP_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"[distributed] {tag}: a rank ran past "
                             f"{DDP_TIMEOUT_S} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for rank, (p, path) in enumerate(zip(procs, logs)):
        text = path.read_text()
        if p.returncode != 0:
            raise AssertionError(f"[distributed] {tag} rank {rank} exited "
                                 f"{p.returncode}:\n{text[-3000:]}")
        out.append((text, json.loads(
            (WORK / f"{tag}_{rank}.json").read_text())))
    return out


def ddp_train(tag: str, n: int, conf: str, env: dict = None,
              backend: str = "gloo") -> list:
    """`train --conf conf` as n ranks (or one process, n = 0): -> the
    records, after checking that every rank joined with `backend` and
    logged the same losses."""
    runs = run_ranks(tag, n, ["train", "--conf", conf, "--device", "cuda"],
                     env)
    if n:
        for rank, (text, _) in enumerate(runs):
            if (f"distributed: process {rank}/{n}, backend {backend}"
                    not in text):
                raise AssertionError(f"[distributed] {tag} rank {rank} did "
                                     f"not join the group with {backend}")
        first = runs[0][1]["fetches"]
        if any(r["fetches"] != first for _, r in runs[1:]):
            raise AssertionError(f"[distributed] {tag}: the ranks logged "
                                 "other losses")
    return [r for _, r in runs]


def compare_ddp(tag: str, ranks: list, one: list) -> tuple:
    """The ranks' logged losses against one process's: -> (worst relative
    difference of the train losses, of the dev loss)."""
    got, want = ranks[0]["fetches"], one[0]["fetches"]
    if len(got) != len(want) or not all(math.isfinite(f[0]) for f in got):
        raise AssertionError(f"[distributed] {tag}: {len(got)} losses vs "
                             f"{len(want)}, or not finite: {got}")
    rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, want)]
    train_rel, dev_rel = max(rel[:-1]), rel[-1]
    if train_rel > DDP_TRAIN_RTOL or dev_rel > DDP_DEV_RTOL:
        raise AssertionError(
            f"[distributed] {tag}: losses {[g[0] for g in got]} vs one "
            f"process's {[w[0] for w in want]} (train rel {train_rel:.2e} > "
            f"{DDP_TRAIN_RTOL} or dev rel {dev_rel:.2e} > {DDP_DEV_RTOL})")
    return train_rel, dev_rel


def check_ddp_launches(tag: str, rec: dict, fused: bool) -> None:
    """Every layer of every step and forward on the kernels, per rank."""
    steps, forwards = len(rec["steps"]), len(rec["steps"]) + rec["eval_steps"]
    got = rec["launches"]
    if (got["lstm_bwd"] != lstm_per_pass() * steps
            or got["lstm_fwd"] != lstm_per_pass() * forwards
            or got["fused_dropout"] != (12 * steps if fused else 0)):
        raise AssertionError(
            f"[distributed] {tag}: launches {got} for {steps} train steps "
            f"and {forwards} forwards: a layer or a site bypassed its kernel")


def phase_distributed(torch, conf: str, train: tuple, dev: tuple,
                      card: str) -> dict:
    """train / evaluate --distributed at full width; -> the launches of
    the path by kernel: {"train-ddp": {...}, "evaluate-ddp": {...}}."""
    one_card = {"CUDA_VISIBLE_DEVICES": "0"}   # 2 ranks share it: gloo
    half = BATCH // 2
    launches = {path: dict.fromkeys(("lstm_fwd", "lstm_bwd",
                                     "fused_dropout"), 0)
                for path in ("train-ddp", "evaluate-ddp")}

    def add(path, recs):
        for r in recs:
            for k in launches[path]:
                launches[path][k] += r["launches"][k]

    # (a) equivalence, dropout 0, streaming (global schedule) and cached
    timings = {}
    for loader, cached in (("streaming", False), ("cached", True)):
        confs = {b: write_train_yaml(
            train, dev, 1, exp_name=f"ddp_{loader}_{b}", batch_size=b,
            drop_out=0.0, device_cache=cached, data_parallel=0)
            for b in (BATCH, half)}
        one = ddp_train(f"ddp_{loader}_1x{BATCH}", 0, confs[BATCH], one_card)
        two = ddp_train(f"ddp_{loader}_2x{half}", 2, confs[half], one_card)
        for r in one + two:
            check_ddp_launches(f"{loader}", r, fused=False)
        add("train-ddp", two)
        train_rel, dev_rel = compare_ddp(loader, two, one)
        timings[loader] = (one, two)
        log(f"[distributed] train {loader}: 2 ranks x {half} on one card "
            f"(gloo) vs 1 x {BATCH}, 1 epoch at dropout 0: the ranks' "
            f"{len(two[0]['fetches'])} logged losses equal bit for bit; "
            f"train losses within {train_rel:.2e} of one process's (tol "
            f"{DDP_TRAIN_RTOL}), dev loss {two[0]['fetches'][-1][0]:.6f} vs "
            f"{one[0]['fetches'][-1][0]:.6f} (rel {dev_rel:.2e}, tol "
            f"{DDP_DEV_RTOL})")

    # (b) the kernels on the path: dropout 0.2 through the fused kernel
    fused_conf = write_train_yaml(train, dev, 1, exp_name="ddp_fused",
                                  batch_size=half, data_parallel=0)
    fused = ddp_train(f"ddp_fused_2x{half}", 2, fused_conf,
                      {**one_card, "SMOKE_FUSED": "1"})
    for rank, r in enumerate(fused):
        check_ddp_launches("fused", r, fused=True)
        log(f"[distributed] train with use_fused_dropout, rank {rank}: "
            f"launches {r['launches']} over {len(r['steps'])} train steps "
            f"and {r['eval_steps']} dev forwards; first step loss "
            f"{r['fetches'][0][0]:.4f}, epoch mean {r['fetches'][-2][0]:.4f}")
    add("train-ddp", fused)

    # (c) evaluate --distributed, beam + LM, on train-fused's best
    lm = str(WORK / "lm.arpa")
    for b in (1, BATCH):
        yaml_path = write_eval_yaml(conf, f"eval_ddp_b{b}", dev, lm,
                                    batch_size=b)
        args = ["evaluate", "--conf", yaml_path, "--device", "cuda"]
        one = run_ranks(f"eval_ddp_b{b}_1", 0, args, one_card)
        two = run_ranks(f"eval_ddp_b{b}_2", 2, args, one_card)
        reports = [parse_report(t) for t, _ in one + two]
        # each rank decodes its half of the dev split
        want = {"lstm_fwd": lstm_per_pass() * -(-(DEV_UTTS // 2) // b),
                "lstm_bwd": 0,
                "fused_dropout": 0}
        if any(r["launches"] != want for _, r in two):
            raise AssertionError(
                f"[distributed] evaluate at batch {b}: lstm_fwd launches "
                f"{[r['launches'] for _, r in two]}, not {want} a rank")
        add("evaluate-ddp", [r for _, r in two])
        if reports[2] != reports[1]:
            raise AssertionError("[distributed] evaluate: the ranks printed "
                                 "other reports")
        same = reports[0] == reports[1]
        if b == 1 and not same:
            raise AssertionError(
                f"[distributed] evaluate at batch 1: 2 ranks' tallies "
                f"{reports[1]} vs one process's {reports[0]}")
        ups = [DEV_UTTS / r["eval_s"] for _, r in one]
        ups2 = DEV_UTTS / max(r["eval_s"] for _, r in two)
        log(f"[distributed] evaluate beam + LM at batch {b}: 2 ranks' "
            f"tallies {'equal' if same else 'differ from'} one process's "
            f"(PER {reports[1]['per']:.4f} vs {reports[0]['per']:.4f}); "
            f"{DEV_UTTS} utterances: {ups[0]:.1f} utts/s in one process, "
            f"{ups2:.1f} utts/s over 2 ranks on one card; lstm_fwd "
            f"launches by rank {[r['launches']['lstm_fwd'] for _, r in two]}"
            f" ({card})")

    # (d) step medians and the gradient all-reduce
    med = lambda xs: statistics.median(xs) * 1e3
    for loader, (one, two) in timings.items():
        log(f"[distributed] step median {loader}: 1 x {BATCH} "
            f"{med(one[0]['steps']):.2f} ms, 2 x {half} on one card "
            f"{med(two[0]['steps']):.2f} / {med(two[1]['steps']):.2f} ms by "
            f"rank, of which the gradient all-reduce (gloo, "
            f"{two[0]['grad_bytes'] / 1e6:.1f} MB of float32) "
            f"{med(two[0]['reduces']):.2f} / {med(two[1]['reduces']):.2f} "
            f"ms ({card})")

    # (e) NCCL across 2 cards, and 4 where there are 4: N ranks x 64 / N
    cards = torch.cuda.device_count()
    for n in (2, 4):
        if cards < n:
            log(f"[distributed] (e) {n} ranks over {n} cards (nccl): not "
                f"run, this machine has {cards} card(s)")
            continue
        env = {"CUDA_VISIBLE_DEVICES": ",".join(map(str, range(n)))}
        for loader, cached in (("streaming", False), ("cached", True)):
            conf_n = write_train_yaml(
                train, dev, 1, exp_name=f"ddp_nccl{n}_{loader}",
                batch_size=BATCH // n, drop_out=0.0, device_cache=cached,
                data_parallel=0)
            recs = ddp_train(f"ddp_nccl{n}_{loader}", n, conf_n, env,
                             backend="nccl")
            for r in recs:
                check_ddp_launches(f"nccl {loader}", r, fused=False)
            add("train-ddp", recs)
            train_rel, dev_rel = compare_ddp(f"nccl {loader}", recs,
                                             timings[loader][0])
            log(f"[distributed] train {loader}: {n} ranks x {BATCH // n} over "
                f"{n} cards (nccl) vs 1 x {BATCH}: train losses within "
                f"{train_rel:.2e} of one process's, dev rel {dev_rel:.2e}; "
                f"step median {[round(med(r['steps']), 2) for r in recs]} ms "
                f"by rank vs {med(timings[loader][0][0]['steps']):.2f} ms, "
                f"gradient all-reduce "
                f"{[round(med(r['reduces']), 2) for r in recs]} ms ({card})")
    return launches


SYN_FULL = ROOT / "checkpoints" / "syn_full"
GOLDEN = ROOT / "results" / "syn_full_best_mdd_tpu_cpu"
# leaves_sha256 of checkpoints/syn_full/best as orbax restores it, from the
# repo root where JAX and orbax are installed:
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu');
#   from mdd_tpu.train.checkpoint import load_checkpoint;
#   from chip_smoke import leaves_sha256;
#   print(leaves_sha256(load_checkpoint('checkpoints/syn_full', 'best')[0]))"
SYN_FULL_SHA256 = (
    "ba17a57ec0bb2ae7241172df16ae16f13a3b1cb91358a18228896ac42300770d")
TRAINED_MATCH = 0.99    # share of the 900 decodes identical to mdd_tpu's
TRAINED_PER_GAP = 0.10  # PER points from mdd_tpu's own decode of the split
# the benchmark's evaluation on seeded random weights, as PERF.md records
# it (H100 80GB HBM3 at 700 W), for the trained model's rates to stand by
RANDOM_WEIGHT_EVAL = ("336-415 utts/s streaming, 457-619 cached (random "
                      "weights, the benchmark's eval section; PERF.md)")


def leaves_sha256(tree) -> str:
    """SHA-256 over the leaves of nested dicts (in sorted key order) and
    lists: each array's path, dtype, shape and bytes, each None's path."""
    import numpy as np

    digest = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (str(key),))
            return
        if isinstance(node, list):
            for i, value in enumerate(node):
                walk(value, path + (str(i),))
            return
        if node is None:
            digest.update(f"{'/'.join(path)}|None|".encode())
            return
        a = np.ascontiguousarray(node)
        digest.update(f"{'/'.join(path)}|{a.dtype.str}|{a.shape}|".encode())
        digest.update(a.tobytes())

    walk(tree, ())
    return digest.hexdigest()


def write_trained_split() -> Path:
    """The corpus checkpoints/syn_full/best was trained on, regenerated
    by the port's tool (easy profile, 5,496 / 897 / 900, 16-40 phones,
    the 41 units) under WORK/syn_full; -> its YAML
    (conf/synthetic_full.yaml's)."""
    from mdd_tpu_torch.tools import synthetic_corpus

    corpus = WORK / "syn_full"
    t0 = time.perf_counter()
    synthetic_corpus.cli([str(corpus), "5496", "897", "900",
                          "--min-phones", "16", "--max-phones", "40",
                          "--units", str(HARD_UNITS)])
    log(f"[trained] corpus 5,496 / 897 / 900 (easy profile) in "
        f"{time.perf_counter() - t0:.1f} s")
    conf = WORK / "syn_full.yaml"
    conf.write_text((ROOT / "conf" / "synthetic_full.yaml").read_text()
                    .replace("data/synthetic_full/", f"{corpus}/"))
    return conf


def phase_trained(torch, files, card: str) -> dict:
    """mdd_tpu's trained checkpoint through the port's entry points, read
    straight from its orbax files; -> the lstm_fwd launches by path."""
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.evals.evaluate import EvalSession
    from mdd_tpu_torch.evals.wer import read_trn
    from mdd_tpu_torch.ops.lstm_cuda import lstm_fwd_kernel
    from mdd_tpu_torch.train.checkpoint import (load_checkpoint,
                                                save_checkpoint)
    from mdd_tpu_torch.train.orbax_format import read_orbax_checkpoint

    started = time.perf_counter()
    # (a) the read, its bits against orbax's
    t0 = time.perf_counter()
    tree = read_orbax_checkpoint(str(SYN_FULL / "best"))
    read_s = time.perf_counter() - t0
    digest = leaves_sha256(tree)
    n_leaves = sum(1 for _ in _leaves(tree))
    t0 = time.perf_counter()
    state, meta = load_checkpoint(str(SYN_FULL), "best")
    load_s = time.perf_counter() - t0
    log(f"[trained] read {SYN_FULL / 'best'} (orbax, OCDBT + zarr, "
        f"{sum(v.numel() for v in state.values()):,} parameters) in "
        f"{read_s:.3f} s; read + bridge to a state dict {load_s:.3f} s; "
        f"{n_leaves} leaves, SHA-256 {digest} (orbax's: "
        f"{SYN_FULL_SHA256}) ({card})")
    if digest != SYN_FULL_SHA256 or n_leaves != 53 or len(state) != 53:
        raise AssertionError("the port's read of checkpoints/syn_full/best "
                             "differs from orbax's")

    # (b) evaluate on the regenerated test split, against mdd_tpu's decode
    conf = write_trained_split()
    golden = parse_report((GOLDEN / "eval.log").read_text())
    want = read_trn(str(GOLDEN / "decode_seq.log"))
    forward = EvalSession._forward
    ran = {"forwards": 0}

    def counted_forward(self, *args):
        ran["forwards"] += 1
        return forward(self, *args)

    launches = {}
    EvalSession._forward = counted_forward
    try:
        for kind, flags in (("evaluate", []), ("evaluate-cached",
                                               ["--cached"])):
            dump = WORK / f"trained_{kind}"
            ran["forwards"] = 0
            lstm_fwd_kernel.launches = 0
            zero_path_launches()
            t0 = time.perf_counter()
            text = run_cli(["evaluate", "--conf", str(conf), "--checkpoint",
                            str(SYN_FULL / "best"), "--device", ONE_CARD,
                            "--dump-dir", str(dump)] + flags)
            wall = time.perf_counter() - t0
            launches[kind] = lstm_fwd_kernel.launches
            beams = record_path_launches(f"trained-{kind}")["ctc_beam"]
            if beams != ran["forwards"]:
                raise AssertionError(f"{kind}: {beams} ctc_beam launches for "
                                     f"{ran['forwards']} forwards (beam 10)")
            (WORK / f"trained_{kind}.log").write_text(text)
            got = parse_report(text)
            decode_min = float(re.search(
                r"time used for decode \d+ sentences: (\S+) minutes",
                text).group(1))
            mine = read_trn(str(dump / "decode_seq.log"))
            same = sum(mine.get(u) == v for u, v in want.items())
            log(f"[trained] {kind}: {same} / {len(want)} decodes identical "
                f"to mdd_tpu's; PER {got['per']:.4f} ({got['errors']} / "
                f"{got['tokens']}) vs mdd_tpu's {golden['per']:.4f} "
                f"({golden['errors']} / {golden['tokens']}); TA {got['TA']} "
                f"FR {got['FR']} FA {got['FA']} TR {got['TR']} (mdd_tpu: TA "
                f"{golden['TA']} FR {golden['FR']} FA {golden['FA']} TR "
                f"{golden['TR']}); F1 {got['f1']:.2f}; "
                f"{900 / (decode_min * 60):.1f} utts/s by the report's "
                f"decode time, {wall:.2f} s of command with set-up; lstm_fwd "
                f"{launches[kind]} launches over {ran['forwards']} forwards, "
                f"ctc_beam {beams} ({card}); random weights: "
                f"{RANDOM_WEIGHT_EVAL}")
            if got["utts"] != 900 \
                    or launches[kind] != lstm_per_pass() * ran["forwards"] \
                    or ran["forwards"] < -(-900 // 256):
                raise AssertionError(
                    f"{kind}: {got['utts']} utterances, {launches[kind]} "
                    f"lstm_fwd launches for {ran['forwards']} forwards")
            if kind == "evaluate" and (
                    same < TRAINED_MATCH * len(want)
                    or abs(got["per"] - golden["per"]) > TRAINED_PER_GAP):
                raise AssertionError(
                    f"the trained model's decodes are not mdd_tpu's: {same} "
                    f"of {len(want)} identical (bar {TRAINED_MATCH}), PER "
                    f"{got['per']} vs {golden['per']}")
    finally:
        EvalSession._forward = forward
    # the trained model's evaluate with its text BiLSTM on the kernels
    # against the plain loop, in turns (not counted: the path's launches
    # were read above)
    from mdd_tpu_torch.ops.lstm import bilstm

    route = {"rnn": None}

    def routed_forward(self, *args):
        if route["rnn"] is not None:
            self.model.text.lstm.rnn = route["rnn"]
        return forward(self, *args)

    rates = {"kernels": [], "plain loop": []}
    EvalSession._forward = routed_forward
    try:
        for which in ("kernels", "plain loop", "plain loop", "kernels"):
            route["rnn"] = None if which == "kernels" else bilstm
            text = run_cli(["evaluate", "--conf", str(conf), "--checkpoint",
                            str(SYN_FULL / "best"), "--device", ONE_CARD])
            decode_min = float(re.search(
                r"time used for decode \d+ sentences: (\S+) minutes",
                text).group(1))
            rates[which].append(round(900 / (decode_min * 60), 1))
    finally:
        EvalSession._forward = forward
    log(f"[trained] evaluate utts/s by the report's decode time, the text "
        f"BiLSTM on the kernels {rates['kernels']}, on the plain loop "
        f"{rates['plain loop']} (in turns) ({card})")
    # the corpus stays for phase local-cards

    # (c) serve from the orbax directory and from a .pt of the same weights
    pt_dir = WORK / "trained_pt"
    save_checkpoint(str(pt_dir), "best", state, meta)
    serve_yaml = WORK / "trained_serve.yaml"
    serve_yaml.write_text(re.sub(r"vocab_file: .*",
                                 f"vocab_file: {HARD_UNITS}",
                                 (WORK / "serve.yaml").read_text()))
    lines = [request(files, i % len(files["paths"]), rid=i)
             for i in range(2 * len(files["paths"]))]
    answers = {}
    for kind, ckpt in (("serve", SYN_FULL / "best"), ("serve-pt", pt_dir)):
        args = list(files["args"])
        args[args.index("--conf") + 1] = str(serve_yaml)
        args[args.index("--checkpoint") + 1] = str(ckpt)
        lstm_fwd_kernel.launches = 0
        out, err = io.StringIO(), io.StringIO()
        stdin = sys.stdin
        sys.stdin = io.StringIO("\n".join(lines) + "\n")
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(args + ["--quiet"])
        finally:
            sys.stdin = stdin
        if rc != 0:
            raise AssertionError(f"{kind} exited {rc}: {err.getvalue()}")
        resps = [json.loads(l) for l in out.getvalue().splitlines()]
        # the trained model hears the seeded tones as nothing it knows:
        # every phone wrong plus insertions, down to word_score's floor
        check_ok(resps, len(lines), lowest=-10)
        tail = err.getvalue().strip().splitlines()[-1]
        forwards = int(tail.split(" in ")[1].split()[0])
        launches[kind] = lstm_fwd_kernel.launches
        if launches[kind] != lstm_per_pass() * forwards:
            raise AssertionError(f"{kind}: {launches[kind]} lstm_fwd "
                                 f"launches for {forwards} forwards")
        answers[kind] = [{k: v for k, v in r.items()
                          if k not in ("seconds", "amortized_seconds")}
                         for r in resps]
        log(f"[trained] {kind} --checkpoint {ckpt}: "
            f"{len(lines)} requests ok; {tail}")
    if answers["serve"] != answers["serve-pt"]:
        raise AssertionError("serve answers from the orbax checkpoint differ "
                             "from those of its .pt")
    log(f"[trained] serve: the {len(lines)} answers from the orbax directory "
        f"equal those from the .pt; phase trained in "
        f"{time.perf_counter() - started:.1f} s")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


LOCAL_TIMEOUT_S = 600   # one command over the local cards, set-up included


def local_run(tag: str, args: list) -> tuple:
    """`python -m mdd_tpu_torch <args>` through cli.main in this process,
    so that the port's launcher starts the ranks, each as RANK_BOOT; ->
    (rank 0's output, the ranks' records).  A command that outlives
    LOCAL_TIMEOUT_S is stopped as Ctrl-C stops it (SIGINT to this
    process, which the launcher passes to its ranks) and fails the
    phase."""
    import signal

    from mdd_tpu_torch.parallel import launch

    for old in WORK.glob(f"{tag}_*.json"):
        old.unlink()
    os.environ["SMOKE_ROOT"] = str(ROOT)
    entry = launch.RANK_ENTRY
    launch.RANK_ENTRY = (sys.executable, "-c", RANK_BOOT,
                         str(WORK / f"{tag}_RANK.json"))
    watchdog = threading.Timer(LOCAL_TIMEOUT_S, os.kill,
                               (os.getpid(), signal.SIGINT))
    watchdog.start()
    try:
        text = run_cli(args)
    finally:
        watchdog.cancel()
        launch.RANK_ENTRY = entry
    recs = []
    while (WORK / f"{tag}_{len(recs)}.json").exists():
        recs.append(json.loads((WORK / f"{tag}_{len(recs)}.json")
                               .read_text()))
    return text, recs


def check_local_ranks(tag: str, recs: list, n: int) -> None:
    """n ranks, one a card (rank r on card r), joined by nccl."""
    got = [(r.get("world"), r.get("backend"), r.get("card")) for r in recs]
    if got != [(n, "nccl", r) for r in range(n)]:
        raise AssertionError(f"[local-cards] {tag}: ranks (size, backend, "
                             f"card) {got}, not {n} ranks on cards "
                             f"0-{n - 1} under nccl")


def phase_local_cards(torch, train: tuple, dev: tuple, card: str) -> dict:
    """`train` and `evaluate` over every local card from one command, as
    mdd_tpu's one-process mesh; -> the lstm_fwd / lstm_bwd /
    fused_dropout launches of the path (every rank's)."""
    import torch.distributed as dist

    from mdd_tpu_torch.evals.wer import read_trn
    from mdd_tpu_torch.ops.dropout_cuda import fused_dropout_kernel
    from mdd_tpu_torch.ops.lstm_cuda import lstm_bwd_kernel, lstm_fwd_kernel
    from mdd_tpu_torch.parallel import launch, mesh
    from mdd_tpu_torch.train.loop import Trainer

    started = time.perf_counter()
    cards = torch.cuda.device_count()
    kernels = {"lstm_fwd": lstm_fwd_kernel, "lstm_bwd": lstm_bwd_kernel,
               "fused_dropout": fused_dropout_kernel}
    launches = dict.fromkeys(kernels, 0)
    steps = -(-TRAIN_UTTS // BATCH)
    forwards = steps + -(-DEV_UTTS // BATCH)
    if cards < 2:
        # (a) data_parallel 0 on one card: today's one process, no group
        conf = write_train_yaml(train, dev, 1, exp_name="local_0",
                                drop_out=0.0, data_parallel=0)
        seen = []
        step, spawn = Trainer.train_step, launch.launch_local

        def watched(self, *args):
            seen.append((dist.is_initialized(), mesh.process_count()))
            return step(self, *args)

        def refused(*args, **kw):
            raise AssertionError("[local-cards] the launcher started ranks "
                                 "on a one-card host")
        Trainer.train_step, launch.launch_local = watched, refused
        try:
            for k in kernels.values():
                k.launches = 0
            run_cli(["train", "--conf", conf, "--device", "cuda"])
            got = {n: k.launches for n, k in kernels.items()}
            # (b) two cards asked of one: make_mesh's error, no rank
            wide = write_train_yaml(train, dev, 1, exp_name="local_2",
                                    data_parallel=2)
            try:
                run_cli(["train", "--conf", wide, "--device", "cuda"])
            except ValueError as e:
                refusal = str(e)
            else:
                raise AssertionError("[local-cards] data_parallel: 2 ran on "
                                     "a one-card host")
        finally:
            Trainer.train_step, launch.launch_local = step, spawn
        if seen != [(False, 1)] * steps or got != {
                "lstm_fwd": lstm_per_pass() * forwards,
                "lstm_bwd": lstm_per_pass() * steps,
                "fused_dropout": 0}:
            raise AssertionError(
                f"[local-cards] data_parallel 0 on one card: steps ran "
                f"(group, processes) {seen}, launches {got}")
        if refusal != "requested 2 devices, have 1":
            raise AssertionError(f"[local-cards] data_parallel: 2 raised "
                                 f"{refusal!r}, not make_mesh's error")
        for k in launches:
            launches[k] += got[k]
        log(f"[local-cards] one card: data_parallel 0 trained {steps} steps "
            f"in this process without a process group (launches {got}); "
            f"data_parallel 2 raised ValueError({refusal!r}) before any "
            f"rank; the runs over 2+ cards and the kernels on cuda:1: not "
            f"run, this machine has {cards} card ({card}); phase in "
            f"{time.perf_counter() - started:.1f} s")
        shutil.rmtree(WORK / "syn_full", ignore_errors=True)
        return launches

    # (a) train: data_parallel 1 (one process) against 2 and every card
    med = lambda xs: statistics.median(xs) * 1e3
    one = ddp_train("local_1", 0, write_train_yaml(
        train, dev, 1, exp_name="local_1", drop_out=0.0))
    check_ddp_launches("local 1", one[0], fused=False)
    widths = [2] + ([0] if cards > 2 else [])
    for dp in widths:
        n = dp or cards
        tag = f"local_{n}"
        conf = write_train_yaml(train, dev, 1, exp_name=tag, drop_out=0.0,
                                data_parallel=dp)
        text, recs = local_run(tag, ["train", "--conf", conf, "--device",
                                     "cuda"])
        check_local_ranks(tag, recs, n)
        for r in recs:
            check_ddp_launches(tag, r, fused=False)
            for k in launches:
                launches[k] += r["launches"][k]
        if any(r["fetches"] != recs[0]["fetches"] for r in recs[1:]):
            raise AssertionError(f"[local-cards] {tag}: the ranks logged "
                                 "other losses")
        if "distributed: process 0/" not in text:
            raise AssertionError(f"[local-cards] {tag}: rank 0's output "
                                 "did not reach the command's")
        train_rel, dev_rel = compare_ddp(tag, recs, one)
        log(f"[local-cards] train data_parallel {dp} = {n} cards (nccl) vs "
            f"one card, B={BATCH} global ({-(-BATCH // n)} a card), 1 "
            f"epoch at dropout 0: train losses within {train_rel:.2e} (tol "
            f"{DDP_TRAIN_RTOL}), dev rel {dev_rel:.2e} (tol {DDP_DEV_RTOL}); "
            f"step median {[round(med(r['steps']), 2) for r in recs]} ms by "
            f"rank vs {med(one[0]['steps']):.2f} ms on one card; gradient "
            f"all-reduce (nccl, {recs[0]['grad_bytes'] / 1e6:.1f} MB) "
            f"{[round(med(r['reduces']), 3) for r in recs]} ms; launches "
            f"by rank {[r['launches'] for r in recs]} ({card})")

    # (b) evaluate the trained model on every card against one card
    conf = WORK / "syn_full.yaml"
    dump = WORK / "local_evaluate"
    text, recs = local_run("local_eval", [
        "evaluate", "--conf", str(conf), "--checkpoint",
        str(SYN_FULL / "best"), "--device", "cuda", "--dump-dir",
        str(dump)])
    check_local_ranks("evaluate", recs, cards)
    for r in recs:
        if (r["launches"]["lstm_fwd"] != lstm_per_pass() * r["forwards"]
                or r["launches"]["lstm_bwd"] or not r["forwards"]):
            raise AssertionError(f"[local-cards] evaluate: launches "
                                 f"{r['launches']} for {r['forwards']} "
                                 "forwards on a rank")
        for k in launches:
            launches[k] += r["launches"][k]
    files = sorted(p.name for p in dump.iterdir())
    mine = read_trn(str(dump / "decode_seq.log"))
    want = read_trn(str(WORK / "trained_evaluate" / "decode_seq.log"))
    same = sum(mine.get(u) == v for u, v in want.items())
    got = parse_report(text)
    one_rep = parse_report((WORK / "trained_evaluate.log").read_text())
    ups = 900 / max(r["eval_s"] for r in recs)
    log(f"[local-cards] evaluate {SYN_FULL / 'best'} on {cards} cards: "
        f"{same} / {len(want)} decodes equal to one card's, PER "
        f"{got['per']:.4f} vs {one_rep['per']:.4f}, {got['utts']} "
        f"utterances; dumps {files}; {ups:.1f} utts/s; forwards by rank "
        f"{[r['forwards'] for r in recs]} ({card})")
    if (files != ["decode_seq.log", "human_seq.log", "transcribe.log"]
            or got["utts"] != 900 or len(mine) != 900
            or same < len(want) - 1
            or abs(got["per"] - one_rep["per"]) > TRAINED_PER_GAP):
        raise AssertionError("[local-cards] evaluate on every card is not "
                             "one card's")
    shutil.rmtree(WORK / "syn_full", ignore_errors=True)

    # (c) the kernels on cuda:1, with cuda:0 current
    local_cards_kernels(torch, card)
    log(f"[local-cards] phase in {time.perf_counter() - started:.1f} s")
    return launches


def local_cards_kernels(torch, card: str) -> None:
    """Each kernel on a tensor of cuda:1 while cuda:0 is current (a rank's
    tensors on another card than the default): against its plain version
    on that card, its barrier counters allocated there."""
    from mdd_tpu_torch.ops import dropout_cuda, lstm_cuda

    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    made = []
    counters = lstm_cuda._barrier_counters

    def recorded(b, device):
        made.append(counters(b, device))
        return made[-1]

    g = torch.Generator().manual_seed(SEED)
    t, b = 80, BATCH
    x_proj = (torch.randn((t, 2, b, 4 * H), generator=g) * 0.5).to(dev)
    w_hh = ((torch.rand((2, H, 4 * H), generator=g) * 2 - 1)
            / H ** 0.5).to(dev)
    dhs = torch.randn((t, 2, b, H), generator=g).to(dev)
    s_xp, s_w = (a.to(dev) for a in scan_inputs(torch, 48, b, SEED + 40)[2:])
    s_dhs = torch.randn((48, 2, b, H), generator=g).to(dev, torch.bfloat16)
    lstm_cuda._barrier_counters = recorded
    try:
        hs, cs = lstm_cuda.lstm_seq_fwd(x_proj, w_hh)
        dxp, dw = lstm_cuda.lstm_seq_bwd(x_proj, w_hh, hs, cs, dhs)
        s_hs, s_cs = lstm_cuda.lstm_scan_fwd(s_xp, s_w)
        s_dxp, s_dw = lstm_cuda.lstm_scan_bwd(s_xp, s_w, s_hs, s_cs, s_dhs)
    finally:
        lstm_cuda._barrier_counters = counters
    s_ref = lstm_cuda.lstm_scan_fwd_reference(s_xp, s_w)
    scan_rel = max(rel_err(a, r) for a, r in zip(
        (s_hs, s_cs, s_dxp, s_dw),
        s_ref + lstm_cuda.lstm_scan_bwd_reference(s_xp, s_w, s_hs, s_cs,
                                                  s_dhs)))
    ref_hs, ref_cs = lstm_cuda.lstm_seq_fwd_reference(x_proj, w_hh)
    ref_dxp, ref_dw = lstm_cuda.lstm_seq_bwd_reference(x_proj, w_hh, hs, cs,
                                                       dhs)
    x = torch.randn((t, b, 2 * H), generator=g).to(dev)
    seed = torch.tensor([SEED + 1], device=dev)
    drop = dropout_cuda.fused_dropout_apply(x, seed, 0.2)
    torch.cuda.synchronize(dev)
    fwd_err = max((hs - ref_hs).abs().max().item(),
                  (cs - ref_cs).abs().max().item())
    bwd_rel = max(rel_err(dxp, ref_dxp), rel_err(dw, ref_dw))
    drop_same = torch.equal(drop, dropout_cuda.fused_dropout_reference(
        x, seed, 0.2))
    where = sorted({str(c.device) for c in made})
    log(f"[local-cards] kernels on cuda:1 (cuda:0 current), T'={t} B={b} "
        f"H={H} float32: lstm_fwd max abs err {fwd_err:.2e} (tol "
        f"{TOL['float32']}), lstm_bwd rel err {bwd_rel:.2e} (tol "
        f"{BWD_TOL['float32']}), fused_dropout bit for bit "
        f"{drop_same}; lstm_scan_fwd / lstm_scan_bwd at T=48 bf16 max rel "
        f"err {scan_rel:.2e} (tol {SCAN_TOL}); barrier counters on {where} "
        f"({card})")
    if (fwd_err > TOL["float32"] or bwd_rel > BWD_TOL["float32"]
            or scan_rel > SCAN_TOL or not drop_same or where != ["cuda:1"]
            or len(made) != 4 or torch.cuda.current_device() != 0):
        raise AssertionError("[local-cards] a kernel on cuda:1 differs from "
                             "its plain version or its counters are not on "
                             "its card")


BENCH_PORT_KEYS = {"card", "peak_flops", "decode_lm", "eval_lm",
                   "eval_n_utts", "n_cards"}   # the port's additions


def bench_py_line_fields() -> tuple:
    """(metric, unit, extra keys) of the repo-root bench.py's line, read
    from its source (an f-string key once a front-end name)."""
    src = (ROOT / "bench.py").read_text()
    field = lambda f: re.search(rf'"{f}": "([^"]+)"', src).group(1)
    keys = set(re.findall(r'extra: dict = \{"([^"]+)"', src))
    for fstr, key in re.findall(r'extra\[(f?)"([^"]+)"\]', src):
        keys |= ({key.format(name=n) for n in ("fbank", "mfcc")} if fstr
                 else {key})
    return field("metric"), field("unit"), keys


def phase_benchmark(torch, card: str) -> dict:
    """`python -m mdd_tpu_torch benchmark` in-process at its full sizes,
    its stdout captured, every Trainer step and evaluation forward
    counted; -> the launch counts of the phase."""
    from mdd_tpu_torch import bench, cli
    from mdd_tpu_torch.evals.evaluate import EvalSession
    from mdd_tpu_torch.ops.dropout_cuda import fused_dropout_kernel
    from mdd_tpu_torch.ops.lstm_cuda import lstm_bwd_kernel, lstm_fwd_kernel
    from mdd_tpu_torch.train.loop import Trainer

    cfg = bench.flagship_config("cuda")
    t_out = cfg.output_frames(bench.FRAMES)
    plan = lstm_bwd_kernel.plan(t_out, bench.BATCH, cfg.rnn_hidden_size,
                                torch.bfloat16)
    ran = {"steps": 0, "forwards": 0}
    step, forward = Trainer.train_step, EvalSession._forward

    def counted_step(self, *args):
        ran["steps"] += 1
        return step(self, *args)

    def counted_forward(self, *args):
        ran["forwards"] += 1
        return forward(self, *args)

    kernels = (lstm_fwd_kernel, lstm_bwd_kernel, fused_dropout_kernel)
    for k in kernels:
        k.launches = 0
    zero_path_launches()
    out = io.StringIO()
    Trainer.train_step, EvalSession._forward = counted_step, counted_forward
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["benchmark", "--device", ONE_CARD])
        torch.cuda.synchronize()
    finally:
        Trainer.train_step, EvalSession._forward = step, forward
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd, bwd, drops = (k.launches for k in kernels)
    new = record_path_launches("benchmark")
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"[benchmark] {line}")
    log(f"[benchmark] `benchmark` in {wall:.1f} s, rc {rc}, {len(lines)} "
        f"stdout line(s); {ran['steps']} Trainer steps, {ran['forwards']} "
        f"evaluation forwards; lstm_fwd {fwd}, lstm_bwd {bwd}, "
        f"lstm_scan_fwd {new['lstm_scan_fwd']}, lstm_scan_bwd "
        f"{new['lstm_scan_bwd']}, fused_dropout {drops}, greedy_wer "
        f"{new['greedy_wer']}, ctc_beam {new['ctc_beam']}; lstm_bwd's "
        f"recurrence at B={bench.BATCH}, "
        f"T'={t_out} in {plan['launches']} launch(es) of "
        f"{plan['chunk_rows']} rows; peak device memory {peak_gib:.1f} GiB "
        f"({card})")
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"benchmark returned {rc} with {len(lines)} "
                             "stdout lines, not one JSON line")
    got = json.loads(lines[0])
    metric, unit, keys = bench_py_line_fields()
    extra = got["extra"]
    missing = sorted((keys | BENCH_PORT_KEYS) - set(extra))
    if got["metric"] != metric or got["unit"] != unit or missing:
        raise AssertionError(f"metric {got['metric']!r} / unit "
                             f"{got['unit']!r} (bench.py: {metric!r} / "
                             f"{unit!r}); extra keys missing: {missing}")
    if extra["peak_flops"] != PEAK_FLOPS["bfloat16"]:
        raise AssertionError(f"peak_flops {extra['peak_flops']}, not the "
                             f"bf16 peak {PEAK_FLOPS['bfloat16']}")
    if not (got["value"] > 0 and extra["mfu"] is not None
            and 0 < extra["mfu"] <= 1):
        raise AssertionError(f"value {got['value']}, mfu {extra['mfu']}")
    if extra["eval_n_utts"] != 900:
        raise AssertionError(f"{extra['eval_n_utts']} evaluated utterances "
                             "a pass, not 900")
    log(f"[benchmark] evaluation of {extra['eval_checkpoint']}: "
        f"{extra['eval_utts_per_s']} utts/s streaming "
        f"({extra['eval_utts_per_s_min']}-{extra['eval_utts_per_s_max']}), "
        f"{extra['eval_utts_per_s_cached']} cached (max "
        f"{extra['eval_utts_per_s_cached_max']}) ({card}); random weights: "
        f"{RANDOM_WEIGHT_EVAL}")
    if extra["eval_checkpoint"] != "syn_full/best":
        raise AssertionError(f"benchmark evaluated {extra['eval_checkpoint']}"
                             ", not the trained syn_full/best")
    # the train steps in bfloat16 (the text BiLSTM on the scan kernels),
    # the evaluation forwards on the trained float32 model
    layers = lstm_per_pass(cfg.compute_dtype)
    if not (cfg.compute_dtype == "bfloat16"
            and new["lstm_scan_fwd"] == ran["steps"]
            and new["lstm_scan_bwd"] == ran["steps"]):
        raise AssertionError(
            f"{new['lstm_scan_fwd']} lstm_scan_fwd / {new['lstm_scan_bwd']} "
            f"lstm_scan_bwd launches for {ran['steps']} {cfg.compute_dtype} "
            "train steps: the text BiLSTM bypassed its kernels")
    if not (ran["steps"] > bench.WARMUP_STEPS + bench.BENCH_STEPS
            and ran["forwards"] > 0 and bwd == layers * ran["steps"]
            and fwd == (layers * ran["steps"]
                        + lstm_per_pass() * ran["forwards"])
            and drops == 0):
        raise AssertionError(
            f"{fwd} lstm_fwd / {bwd} lstm_bwd / {drops} fused_dropout "
            f"launches for {ran['steps']} steps of {layers} layers and "
            f"{ran['forwards']} evaluation forwards of {lstm_per_pass()}: "
            "a layer bypassed its kernel, or dropout ran fused")
    # a WER and a CTC forward a Trainer step, a CTC backward a train step;
    # a beam launch an evaluation forward (beam 10) and a decode round
    if not (new["greedy_wer"] >= ran["steps"]
            and new["ctc_alpha"] == new["greedy_wer"]
            and new["ctc_beta_grad"] == ran["steps"]
            and new["ctc_beam"] > ran["forwards"]):
        raise AssertionError(f"{new} for {ran['steps']} steps and "
                             f"{ran['forwards']} evaluation forwards: the WER "
                             "or the beam bypassed its kernel")
    profile_bench_step(torch, cfg, card)
    return {"lstm_fwd": fwd, "lstm_bwd": bwd, "fused_dropout": drops}


def profile_bench_step(torch, cfg, card: str) -> None:
    """torch.profiler over 3 steps of the train section's cell (after 2
    warm ones): device busy share and the ops that take the time."""
    from torch.profiler import ProfilerActivity, profile

    from mdd_tpu_torch import bench
    from mdd_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, device="cuda")
    arrays = trainer.batch_arrays(bench.train_batch(
        cfg, bench.BATCH, bench.FRAMES, bench.LABEL_LEN))
    acc = torch.zeros(4, device="cuda")
    for _ in range(2):
        acc = trainer.train_step(arrays, acc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            acc = trainer.train_step(arrays, acc)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, "benchmark",
                   f"3 train steps at B={bench.BATCH} x {bench.FRAMES} "
                   f"frames, {cfg.compute_dtype}", card)


def local_cards_benchmark(cards: int, card: str) -> dict:
    """`python -m mdd_tpu_torch benchmark` as a user runs it on this host
    (a rank on every card): rank 0's one JSON line, with bench.py's
    metric, unit and keys, n_cards the card count, 0 < mfu <= 1 over the
    cards' peak; -> its `extra`."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mdd_tpu_torch", "benchmark"], cwd=ROOT,
        capture_output=True, text=True, timeout=LOCAL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    (WORK / "local_benchmark.err").write_text(proc.stderr)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"[local-cards] benchmark exited "
                             f"{proc.returncode} with {len(lines)} stdout "
                             f"lines:\n{proc.stderr[-3000:]}")
    got = json.loads(lines[0])
    metric, unit, keys = bench_py_line_fields()
    extra = got["extra"]
    log(f"[local-cards] benchmark on {cards} cards in {wall:.1f} s: "
        f"{lines[0]}")
    if (got["metric"] != metric or got["unit"] != unit
            or (keys | BENCH_PORT_KEYS) - set(extra)
            or extra["n_cards"] != cards or not got["value"] > 0
            or extra["mfu"] is None or not 0 < extra["mfu"] <= 1
            or extra["eval_n_utts"] != 900):
        raise AssertionError(f"[local-cards] benchmark on {cards} cards: "
                             f"{lines[0]}")
    return extra


def local_cards_main(torch, card: str) -> int:
    """`python3 chip_smoke.py --local-cards` on a host of two cards or
    more: phase local-cards alone, with what it holds the cards to (the
    trained model's evaluate on one card; the one-card epoch runs inside
    the phase), then `python -m mdd_tpu_torch benchmark` over every card.
    Exits 2 on a host of one card."""
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"chip_smoke --local-cards: {cards} card(s); it needs two",
              file=sys.stderr)
        return 2
    started = time.perf_counter()
    phase_build()
    WORK.mkdir(parents=True, exist_ok=True)
    (WORK / "units").write_text("\n".join(UNITS) + "\n")
    train = write_corpus("train", TRAIN_UTTS, SEED + 2)
    dev = write_corpus("dev", DEV_UTTS, SEED + 3)
    conf = write_trained_split()
    text = run_cli(["evaluate", "--conf", str(conf), "--checkpoint",
                    str(SYN_FULL / "best"), "--device", ONE_CARD,
                    "--dump-dir", str(WORK / "trained_evaluate")])
    (WORK / "trained_evaluate.log").write_text(text)
    local = phase_local_cards(torch, train, dev, card)
    extra = local_cards_benchmark(cards, card)
    shutil.rmtree(WORK, ignore_errors=True)
    log(f"[time] --local-cards in {time.perf_counter() - started:.1f} s")
    print(card)
    print(json.dumps({"local_cards": {"cards": cards, "launches": local,
                                      "benchmark": extra}}))
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "mdd_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repo (mdd_tpu_torch/ "
              "missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mdd_tpu_torch import bench
    from mdd_tpu_torch.utils.precision import tf32_flags

    PEAK_FLOPS.update(bench.PEAK_FLOPS[bench.H100_SXM])

    # nothing here sets the flags for the whole process: a phase that
    # builds a model outside Trainer / EvalSession applies the port's
    # float32 rule itself
    log(f"[precision] at start: {tf32_flags()} (torch's defaults)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = smi
    if sys.argv[1:] == ["--local-cards"]:
        return local_cards_main(torch, card)
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    started = time.perf_counter()

    phase_build()
    worst = phase_kernel(torch)
    worst_bwd = phase_kernel_bwd(torch)
    phase_kernel_staging(torch)
    wer_kernel = phase_kernel_wer(torch, card)
    beam_kernel = phase_kernel_beam(torch, card)
    ctc_kernels = phase_kernel_ctc(torch, card)
    scan_kernels = phase_kernel_scan(torch, card)
    phase_kernel_lstm_parent(torch, parent_tree())
    cfg, meta, state = phase_model(torch)
    vis = phase_visualize(torch, cfg, state, card)
    files = write_serving_files(cfg, meta, state)
    launches, engine = phase_serve(files, card)
    lexicon = phase_lexicon(torch, files, card)
    product = phase_product(torch, files, card)
    phase_profile(torch, engine, files, card)
    train = write_corpus("train", TRAIN_UTTS, SEED + 2)
    dev = write_corpus("dev", DEV_UTTS, SEED + 3)
    trained = phase_trained(torch, files, card)
    local = phase_local_cards(torch, train, dev, card)
    phase_model_grad(torch, cfg, state, dev)
    train_fwd, train_bwd, conf, first_loss = phase_train(torch, train, dev)
    phase_train_strict(train, dev, first_loss, card)
    plateau = phase_resume_plateau(torch, train, dev, card)
    handover = phase_resume_mdd_tpu(torch, train, dev, card)
    phase_step_time(torch, conf, card)
    timing, timing_bwd = phase_timing(torch, card)
    dropout_err = phase_kernel_dropout(torch)
    fused = phase_train_fused(torch, conf, card)
    bf16 = phase_train_bf16(torch, train, dev, card)
    cached = phase_train_cached(torch, card)
    eval_fwd, _ = phase_evaluate(torch, conf, train, dev, card)
    eval_cached_fwd = phase_evaluate_cached(torch, cached, card)
    phase_profile_evaluate(torch, conf, train, card)
    ddp = phase_distributed(torch, conf, train, dev, card)
    benchmark = phase_benchmark(torch, card)
    dropout_timing = phase_timing_dropout(torch, card)
    shutil.rmtree(WORK, ignore_errors=True)

    by_batch = {str(b): {k: v for k, v in timing[b].items()
                         if k != "timing_err"} for b in FWD_TIMING_BATCHES}
    kernels = [{
        "name": "lstm_fwd",
        "route": "cuda",
        "source": "mdd_tpu_torch/csrc/lstm_fwd.cu",
        "replaces": "mdd_tpu/ops/lstm_pallas.py:61",
        "launches": (launches + vis["lstm_fwd"] + sum(lexicon.values())
                     + sum(product.values()) + train_fwd
                     + plateau["lstm_fwd"] + handover["lstm_fwd"]
                     + fused["lstm_fwd"] + bf16["lstm_fwd"]
                     + cached["lstm_fwd"] + eval_fwd + eval_cached_fwd
                     + ddp["train-ddp"]["lstm_fwd"]
                     + ddp["evaluate-ddp"]["lstm_fwd"]
                     + sum(trained.values()) + local["lstm_fwd"]
                     + benchmark["lstm_fwd"]),
        "launches_by_path": {"visualize": vis["lstm_fwd"],
                             "serve": launches, **lexicon, **product,
                             **{f"trained-{k}": v
                                for k, v in trained.items()},
                             "train": train_fwd,
                             "resume-plateau": plateau["lstm_fwd"],
                             "resume-mdd_tpu": handover["lstm_fwd"],
                             "train-fused": fused["lstm_fwd"],
                             "train-bf16": bf16["lstm_fwd"],
                             "train-cached": cached["lstm_fwd"],
                             "evaluate": eval_fwd,
                             "evaluate-cached": eval_cached_fwd,
                             "train-ddp": ddp["train-ddp"]["lstm_fwd"],
                             "evaluate-ddp": ddp["evaluate-ddp"]["lstm_fwd"],
                             "local-cards": local["lstm_fwd"],
                             "benchmark": benchmark["lstm_fwd"]},
        "max_abs_err": max(worst["float32"],
                           *(timing[b]["timing_err"] for b in timing)),
        "shape": f"T'=80 B=16 H={H} float32",
        **by_batch["16"],
        "by_batch": by_batch,
    }, {
        "name": "lstm_bwd",
        "route": "cuda",
        "source": "mdd_tpu_torch/csrc/lstm_bwd.cu",
        "replaces": "mdd_tpu/ops/lstm_pallas.py:141",
        "launches": (train_bwd + plateau["lstm_bwd"]
                     + handover["lstm_bwd"] + vis["lstm_bwd"]
                     + fused["lstm_bwd"] + bf16["lstm_bwd"]
                     + cached["lstm_bwd"] + ddp["train-ddp"]["lstm_bwd"]
                     + ddp["evaluate-ddp"]["lstm_bwd"]
                     + local["lstm_bwd"] + benchmark["lstm_bwd"]),
        "launches_by_path": {"visualize": vis["lstm_bwd"],
                             "train": train_bwd,
                             "resume-plateau": plateau["lstm_bwd"],
                             "resume-mdd_tpu": handover["lstm_bwd"],
                             "train-fused": fused["lstm_bwd"],
                             "train-bf16": bf16["lstm_bwd"],
                             "train-cached": cached["lstm_bwd"],
                             "train-ddp": ddp["train-ddp"]["lstm_bwd"],
                             "evaluate-ddp": ddp["evaluate-ddp"]["lstm_bwd"],
                             "local-cards": local["lstm_bwd"],
                             "benchmark": benchmark["lstm_bwd"]},
        "max_abs_err": worst_bwd["float32_abs"],
        "shape": f"T'=80 B={BATCH} H={H} float32",
        **timing_bwd[BATCH],
        "by_batch": {str(b): timing_bwd[b] for b in BWD_TIMING_BATCHES},
    }, {
        "name": "fused_dropout",
        "route": "cuda",
        "source": "mdd_tpu_torch/csrc/dropout.cu",
        "replaces": "mdd_tpu/ops/dropout_pallas.py:53",
        "launches": (vis["fused_dropout"] + fused["fused_dropout"]
                     + bf16["fused_dropout"]
                     + ddp["train-ddp"]["fused_dropout"]
                     + ddp["evaluate-ddp"]["fused_dropout"]
                     + local["fused_dropout"]),
        "launches_by_path": {"visualize": vis["fused_dropout"],
                             "train-fused": fused["fused_dropout"],
                             "train-bf16": bf16["fused_dropout"],
                             "train-ddp": ddp["train-ddp"]["fused_dropout"],
                             "evaluate-ddp":
                                 ddp["evaluate-ddp"]["fused_dropout"],
                             "local-cards": local["fused_dropout"]},
        "max_abs_err": dropout_err,
        "shape": "conv0 site 64x32x220x122 float32",
        **dropout_timing["conv0"]["float32"],
        "by_site": dropout_timing,
    }, {
        "name": "greedy_wer",
        "route": "cuda",
        "source": "mdd_tpu_torch/csrc/wer.cu",
        "replaces": "mdd_tpu/ops/wer.py:32",
        "launches": sum(PATH_LAUNCHES["greedy_wer"].values()),
        "launches_by_path": PATH_LAUNCHES["greedy_wer"],
        **wer_kernel,
    }, {
        "name": "ctc_beam",
        "route": "cuda",
        "source": "mdd_tpu_torch/csrc/ctc_beam.cu",
        "replaces": "mdd_tpu/decode/beam_jit.py:60",
        "launches": sum(PATH_LAUNCHES["ctc_beam"].values()),
        "launches_by_path": PATH_LAUNCHES["ctc_beam"],
        **beam_kernel,
    }, {
        "name": "ctc_alpha",
        "route": "cuda",
        "source": "mdd_tpu_torch/csrc/ctc_loss.cu",
        "replaces": "mdd_tpu/ops/ctc_loss.py:69",
        "launches": sum(PATH_LAUNCHES["ctc_alpha"].values()),
        "launches_by_path": PATH_LAUNCHES["ctc_alpha"],
        **ctc_kernels["ctc_alpha"],
    }, {
        "name": "ctc_beta_grad",
        "route": "cuda",
        "source": "mdd_tpu_torch/csrc/ctc_loss.cu",
        "replaces": "mdd_tpu/ops/ctc_loss.py:113",
        "launches": sum(PATH_LAUNCHES["ctc_beta_grad"].values()),
        "launches_by_path": PATH_LAUNCHES["ctc_beta_grad"],
        **ctc_kernels["ctc_beta_grad"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "mdd_tpu_torch/csrc/lstm_scan.cu",
        "replaces": "mdd_tpu/ops/lstm.py:59",
        "launches": sum(PATH_LAUNCHES[name].values()),
        "launches_by_path": PATH_LAUNCHES[name],
        **scan_kernels[name],
        **({"text_turns": bf16["text_turns"]} if name == "lstm_scan_fwd"
           else {}),
    } for name in ("lstm_scan_fwd", "lstm_scan_bwd")]
    log(f"[time] every phase in {time.perf_counter() - started:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
