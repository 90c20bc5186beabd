"""Where a step of the row-blocked GRU kernels spends its time, on one card.

    python -m deepctr_tpu_torch.tools.gru_parts [--seed S]

Builds ``csrc/gru_scan.cu`` and ``csrc/gru_scan_bwd.cu`` as they are and
with one part of a step taken out, and times each build at DIEN's shape
(bfloat16 storage, B=1024, T=100, H=64, gru mode, history lengths uniform
over [0, 100]), in device ms with a cold L2, median of 20:

- the forward whole; without its product ``h @ W_hh^T`` (the gate tile
  left at a constant); without the gate nonlinearities (affine stand-ins);
  without both;
- the backward's reverse scan whole; without its gate recompute; without
  its ``dh = d_gh @ W_hh``; without both.

A build without a part computes wrong values: only its time is read.  The
parts are cut out by editing the sources' text, so an edit of the kernels
that moves those lines stops this tool with the line it missed.  Prints
one JSON line a build, ``{"kernel", "without", "ms"}``.  Without a CUDA
device it raises.
"""

import argparse
import ctypes
import json
import statistics
import subprocess

import torch

from ..ops import _build
from ..ops import gru

B, T, H = 1024, 100, 64
STD = 0.3

# (kernel, what is taken out) -> [(text, replacement)]; "" takes out nothing
_FWD_PRODUCT = [
    ("    if (product_warp) {\n      // hi*hi, hi*lo and",
     "    if (false) {\n      // hi*hi, hi*lo and"),
    ("  if (tid == 0) t_end_s = 0;",
     "  if (tid == 0) t_end_s = 0;\n"
     "  for (int i = tid; i < kRows * kGs; i += kRowThreads) ghs[i] = 0.1f;"),
]
_FWD_GATES = [
    ("      const float r = sigmoid_f(to_f(ir) + hr);\n"
     "      const float z = sigmoid_f(to_f(iz) + hz);\n"
     "      const float n = tanhf(to_f(in) + r * hn);",
     "      const float r = 0.5f + 0.01f * (to_f(ir) + hr);\n"
     "      const float z = 0.5f + 0.01f * (to_f(iz) + hz);\n"
     "      const float n = 0.01f * (to_f(in) + r * hn);"),
]
_BWD_TILES = (
    "  for (int i = tid; i < kRows * kGs; i += kRowThreads) dgs[i] = 0.0f;",
    "  for (int i = tid; i < kRows * kGs; i += kRowThreads) {\n"
    "    dgs[i] = 0.0f;\n    ghs[i] = 0.1f;\n  }\n"
    "  for (int i = tid; i < kSplits * kRows * kHs; i += kRowThreads) "
    "dps[i] = 0.0f;")
_BWD_GATES = [("    gates(t0);", ""), ("      gates(t - 1);", "")]
_BWD_DH = [("      if (dh_warp) {", "      if (false) {")]
VARIANTS = {
    ("forward", ""): ("gru_scan", []),
    ("forward", "product"): ("gru_scan", _FWD_PRODUCT),
    ("forward", "gate nonlinearities"): ("gru_scan", _FWD_GATES),
    ("forward", "product and gate nonlinearities"):
        ("gru_scan", _FWD_PRODUCT + _FWD_GATES),
    ("backward scan", ""): ("gru_scan_bwd", []),
    ("backward scan", "gate recompute"):
        ("gru_scan_bwd", [_BWD_TILES] + _BWD_GATES),
    ("backward scan", "dh product"): ("gru_scan_bwd", [_BWD_TILES] + _BWD_DH),
    ("backward scan", "both products"):
        ("gru_scan_bwd", [_BWD_TILES] + _BWD_GATES + _BWD_DH),
}


def build_variants(variants=None):
    """{key: loaded library} for ``variants`` ({key: (name, [(text,
    replacement)])}, ``csrc/<name>.cu`` edited; VARIANTS by default), one
    nvcc for each build, all started together, into ``_build/parts/``."""
    variants = VARIANTS if variants is None else variants
    out_dir = _build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (key, (name, edits)) in enumerate(variants.items()):
        text = (_build.SRC_DIR / ("%s.cu" % name)).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError("csrc/%s.cu no longer holds %r"
                                   % (name, old))
            text = text.replace(old, new)
        src = out_dir / ("%s_%d.cu" % (name, i))
        src.write_text(text)
        lib = out_dir / ("lib%s_%d.so" % (name, i))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        jobs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True),
                     lib)
    libs = {}
    for key, (proc, lib) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (key, log))
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def device_ms(fn, runs=20, cold=True):
    """Median device time of ``fn`` over ``runs`` runs, each after a stall
    longer than the host's enqueue and, with ``cold``, a 128 MB write that
    evicts the L2."""
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(runs):
        torch.cuda._sleep(2_000_000)
        if cold:
            flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def make_inputs(seed):
    """DIEN's GRU inputs at the bench shape, on the card, from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16
    gi = torch.randn(B, T, 3 * H, generator=gen, device="cuda").to(
        bf16).transpose(0, 1)
    whh_t = (STD * torch.randn(H, 3 * H, generator=gen,
                               device="cuda")).to(bf16).float()
    bhh = (STD * torch.randn(3 * H, generator=gen,
                             device="cuda")).to(bf16).float()
    lengths = torch.randint(0, T + 1, (B,), generator=gen, device="cuda")
    mask = torch.arange(T, device="cuda")[None, :] < lengths[:, None]
    douts = torch.randn(B, T, H, generator=gen, device="cuda").to(
        bf16).transpose(0, 1)
    dh_last = torch.randn(B, H, generator=gen, device="cuda").to(bf16)
    with torch.no_grad():
        _, _, carry = gru.gru_scan_with_carry(gi, whh_t, bhh, mask)
    return gi, whh_t, bhh, mask, carry, douts, dh_last


def forward_call(lib, inputs):
    gi, whh_t, bhh, mask, _, _, _ = inputs
    fn = gru._kernel(lib)
    out = torch.empty(B, T, H, dtype=gi.dtype, device="cuda")
    h_last = torch.empty(B, H, dtype=gi.dtype, device="cuda")

    def call():
        rc = fn(1, gru.MODES["gru"], gi.data_ptr(), gi.stride(0),
                gi.stride(1), whh_t.data_ptr(), bhh.data_ptr(),
                mask.data_ptr(), None, 0, B, T, H, out.data_ptr(),
                out.stride(1), out.stride(0), h_last.data_ptr(), None,
                torch.cuda.current_stream().cuda_stream)
        gru._raise_on(rc, "gru_scan", H)
    return call


def scan_call(lib, inputs):
    gi, whh_t, bhh, mask, carry, douts, dh_last = inputs
    scratch_fn, fn = gru._bwd_kernel(lib)
    whh = whh_t.t().contiguous()
    dgi = torch.empty(B, T, 3 * H, dtype=gi.dtype,
                      device="cuda").transpose(0, 1)
    dwhh = torch.empty(H, 3 * H, device="cuda")
    dbhh = torch.empty(3 * H, device="cuda")
    scratch = torch.empty(scratch_fn(B, T, H), device="cuda")

    def call():
        rc = fn(gru.BWD_SCAN, 1, gru.MODES["gru"], gi.data_ptr(),
                gi.stride(0), gi.stride(1), carry.data_ptr(),
                whh_t.data_ptr(), whh.data_ptr(), bhh.data_ptr(),
                mask.data_ptr(), None, 0, douts.data_ptr(), douts.stride(0),
                douts.stride(1), dh_last.data_ptr(), dh_last.stride(0), B, T,
                H, dgi.data_ptr(), dgi.stride(0), dgi.stride(1),
                dwhh.data_ptr(), dbhh.data_ptr(), None, scratch.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        gru._raise_on(rc, "gru_scan_bwd", H)
    return call


def run(seed=0):
    """The records, one a build."""
    if not torch.cuda.is_available():
        raise RuntimeError("gru_parts times kernels on a CUDA device")
    libs = build_variants()
    inputs = make_inputs(seed)
    records = []
    for (kernel, without), lib in libs.items():
        call = (forward_call if kernel == "forward" else scan_call)(lib,
                                                                    inputs)
        records.append({"kernel": kernel, "without": without,
                        "ms": device_ms(call)})
    return records


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    for rec in run(args.seed):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
