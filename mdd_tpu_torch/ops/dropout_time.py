"""Time the fused dropout kernel on the card, and variants of it.

    python -m mdd_tpu_torch.ops.dropout_time [--source a.cu b.cu]
        [--sites conv0 conv1 bilstm] [--dtype float32 bfloat16]
        [--iters 50] [--sass] [--host]

At each dropout site of a train step at B=64, T'=110 (the two convolution
outputs and a BiLSTM output) and in each dtype: the package's kernel
(`csrc/dropout.cu`), each `--source` file (a variant with the same entry
point, kept outside `csrc/`; it includes the headers of `csrc/`) and
F.dropout (the yardstick only), timed in turns, first in that order and
then in reverse.  Each gets two times: a call as the model makes it (CUDA
events over back-to-back calls, so the host's cost of a call shows when it
exceeds the kernel's), and the kernel's own device time (torch.profiler).
Inputs rotate over enough buffers that no call finds its input in L2.  A
variant's output is held against `fused_dropout_reference` bit for bit
("bits equal"; a diagnostic variant that drops Philox is not).  `--sass`
prints each kernel's instruction mix from `cuobjdump -sass`; `--host` the
host's cost of a call and of its parts, on a tensor too small for the
device to bound the loop.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import math
import re
import subprocess
from pathlib import Path

import torch

from mdd_tpu_torch.ops import build, dropout_cuda
from mdd_tpu_torch.ops.dropout_cuda import (
    OPS_PER_ELEMENT,
    PEAK_BYTES_S,
    PEAK_INT_OPS_S,
    SITES,
    bound_ms,
)
from mdd_tpu_torch.ops.lstm_stamps import event_ms

ROTATE_BYTES = 200_000_000   # inputs a timing loop walks, > the 50 MB L2


def device_ms(fn, iters: int, name: str = "dropout") -> float:
    """Mean device time of a kernel whose name holds `name`, over `iters`
    calls that launch one each (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A profiler window has come back without the kernels it ran (rarely,
    # on an H100 host); such a window is taken again, twice at most.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in events)
        if count:
            # over the launches it saw: it may drop some of a window's events
            return sum(e.self_device_time_total for e in events) / 1e3 / count
    raise RuntimeError(f"the profiler saw no kernel named *{name}* in 3 "
                       "windows")


def rotating(shape, dtype, count: int | None = None):
    """-> a function that returns the next of enough seeded inputs of
    `shape` that their bytes exceed ROTATE_BYTES."""
    n = math.prod(shape)
    if count is None:
        count = max(2, -(-ROTATE_BYTES // (n * torch.finfo(dtype).bits // 8)))
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(shape, generator=g, device="cuda").to(dtype)
          for _ in range(count)]
    turn = iter(range(10 ** 12))
    return lambda: xs[next(turn) % count], xs


def binding(source: str | None) -> dropout_cuda.FusedDropoutKernel:
    """The package's kernel, or the file `source` with its entry point."""
    kernel = dropout_cuda.FusedDropoutKernel()
    if source:
        kernel.source = str(Path(source).resolve())
    return kernel


def time_site(name: str, dtype: torch.dtype, kernels: dict, iters: int,
              rate: float = 0.2, plain_iters: int = 0) -> dict:
    """-> {label: ([per-call ms], [kernel ms], bits equal)} for every kernel
    and F.dropout at one site, timed in turns (forward, then reverse
    order); with `plain_iters`, also "plain": fused_dropout_reference's
    per-call time (events only, once)."""
    import torch.nn.functional as F

    shape = SITES[name]
    pick, xs = rotating(shape, dtype)
    seed = torch.tensor([0x5EED_0F_D0], device="cuda")
    runs = {label: (lambda k=k: k(pick(), seed, rate))
            for label, k in kernels.items()}
    runs["F.dropout"] = lambda: F.dropout(pick(), rate, True)
    plain = {}
    if plain_iters:
        plain["plain"] = ([event_ms(
            lambda: dropout_cuda.fused_dropout_reference(pick(), seed, rate),
            plain_iters, warmup=1)], [], None)
    equal = {}
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    ref = dropout_cuda.fused_dropout_reference(xs[0], seed, rate)
    for label, k in kernels.items():
        equal[label] = torch.equal(k(xs[0], seed, rate).view(bits),
                                   ref.view(bits))
    del ref
    order = list(runs) + list(runs)[::-1]
    per_call = collections.defaultdict(list)
    kernel = collections.defaultdict(list)
    for label in order:
        per_call[label].append(event_ms(runs[label], iters))
        kernel[label].append(device_ms(runs[label], iters))
    return {**{label: (per_call[label], kernel[label], equal.get(label))
               for label in runs}, **plain}


def report(name: str, dtype: torch.dtype, times: dict, card: str) -> None:
    shape = SITES[name]
    n = math.prod(shape)
    bnd, by = bound_ms(n, dtype)
    nbytes = 2 * n * torch.finfo(dtype).bits / 8
    print(f"[dropout] {name} {tuple(shape)} ({n / 1e6:.2f} M elements) "
          f"{str(dtype)[6:]}: bound {bnd:.4f} ms ({by}; bytes "
          f"{nbytes / PEAK_BYTES_S * 1e3:.4f}, integer operations "
          f"{n * OPS_PER_ELEMENT / PEAK_INT_OPS_S * 1e3:.4f}) ({card})")
    for label, (calls, kern, equal) in times.items():
        if not kern:
            continue
        eq = "" if equal is None else f", bits equal {'yes' if equal else 'NO'}"
        print(f"[dropout]   {label:<28s} a call "
              f"{' / '.join(f'{v:.4f}' for v in calls)} ms, kernel "
              f"{' / '.join(f'{v:.4f}' for v in kern)} ms "
              f"({nbytes / min(kern) / 1e6:.0f} GB/s, "
              f"{100 * bnd / min(kern):.0f}% of bound){eq}")


def sass_mix(kernel: dropout_cuda.FusedDropoutKernel) -> None:
    """Each dropout kernel's static instruction mix (cuobjdump -sass)."""
    lib = build.library_path(kernel.source, kernel.extra_flags)
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for func, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s+Function :|\Z)",
                                 text, flags=re.S):
        if "dropout" not in func:
            continue
        ops = collections.Counter(re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", body))
        top = ", ".join(f"{op} {c}" for op, c in ops.most_common(16))
        print(f"[sass] {Path(kernel.source).name} {func}: "
              f"{sum(ops.values())} instructions; {top}")


def host_costs(iters: int = 4000) -> None:
    """Wall clock a call over `iters` back-to-back calls on 4096 elements:
    the model's call (seed draw, autograd, wrapper), the wrapper, the entry
    point with its arguments ready, the parts of a call, and F.dropout."""
    import time

    import torch.nn.functional as F

    dev = torch.device("cuda")
    x = torch.randn(4096, device=dev)
    xg = x.clone().requires_grad_()
    seed = torch.tensor([5], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    kernel = dropout_cuda.fused_dropout_kernel
    entry = getattr(kernel.library(), kernel.entry)
    out = torch.empty_like(x)
    raw = torch.cuda.current_stream(dev).cuda_stream
    threshold = dropout_cuda.keep_threshold(0.2)

    def device_context():
        with torch.cuda.device(dev):
            pass

    calls = {
        "fused_dropout (seed draw, autograd, wrapper)":
            lambda: dropout_cuda.fused_dropout(xg, 0.2, gen),
        "the wrapper, fused_dropout_kernel(x, seed, rate)":
            lambda: kernel(x, seed, 0.2),
        "the entry point, its arguments ready": lambda: entry(
            x.data_ptr(), out.data_ptr(), seed.data_ptr(), x.numel(),
            threshold, 1.25, 0, raw),
        "the seed draw, torch.randint": lambda: torch.randint(
            0, dropout_cuda.SEED_HIGH, (1,), dtype=torch.int64,
            generator=gen, device=dev),
        "torch.empty_like": lambda: torch.empty_like(x),
        "torch.cuda.current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream":
            lambda: torch._C._cuda_getCurrentRawStream(0),
        "the device context, torch.cuda.device": device_context,
        "F.dropout (autograd)": lambda: F.dropout(xg, 0.2, True),
    }
    for turn in (1, 2):
        for name, fn in calls.items():
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            us = (time.perf_counter() - t0) / iters * 1e6
            print(f"[host] turn {turn}: {name:<50s} {us:7.2f} us a call")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", nargs="*", default=[],
                    help=".cu files to time beside the package's kernel")
    ap.add_argument("--sites", nargs="*", default=list(SITES),
                    choices=list(SITES))
    ap.add_argument("--dtype", nargs="*", default=["float32", "bfloat16"],
                    choices=("float32", "bfloat16"))
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--sass", action="store_true",
                    help="print each kernel's instruction mix")
    ap.add_argument("--host", action="store_true",
                    help="print the host's cost of a call and its parts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dropout_time: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    kernels = {"dropout.cu": binding(None)}
    kernels.update({Path(s).name: binding(s) for s in args.source})
    procs = [(k, build.start_build(k.source)) for k in kernels.values()]
    for k, proc in procs:                        # every build at once
        build.finish_build(k.source, proc)
    if args.sass:
        for k in kernels.values():
            sass_mix(k)
    if args.host:
        host_costs()
    for name in args.sites:
        for dtype in args.dtype:
            dt = getattr(torch, dtype)
            report(name, dt, time_site(name, dt, kernels, args.iters), card)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
