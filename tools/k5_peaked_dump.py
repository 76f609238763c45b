"""Where K5's bf16 route loses accuracy on a peaked softmax row (needs a
card).

Builds each given copy of ``flash_attention.cu`` twice under
``build/k5_dump/``: as it is, and instrumented to dump one query row's raw
scores (the Q K^T accumulators before the scale), its final max and sum,
and its f32 output before the bf16 rounding. Then, for each copy:

1. the peaked cases (q x 8) of ``tests/test_torch_gpu.py`` and whisper's
   non-causal shapes over seeds 0-2 against the plain version on the card,
   each case's worst ratio of error to allowance (rtol 1e-2, atol 1e-5);
2. for the worst element of the first case (1, 512, 32 heads, 112, 112,
   causal, seed 0), the error split into its terms against an f64
   computation from the same bf16 q, k, v: the scores (S), P's split into
   bf16 hi + lo, PV's accumulation, and the output's rounding, for the
   kernel and for the plain version;
3. the kernel's time at the paths' shapes (CUDA events, the copies in
   turns A B B A).

    git show 2529de9:src/repro_torch/kernels/csrc/flash_attention.cu \\
        > build/k5_before.cu
    python tools/k5_peaked_dump.py --source build/k5_before.cu \\
        --source src/repro_torch/kernels/csrc/flash_attention.cu
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import backend, ref  # noqa: E402
from repro_torch.models.common import attention_mask  # noqa: E402

OUT = ROOT / "build" / "k5_dump"
RTOL, ATOL = 1e-2, 1e-5
LOG2E = 1.4426950408889634
KEYS = 4096                    # keys the dump holds
#: (name, B, Sq, Sk, H, K, Dk, Dv, causal, window): the card test's
#: peaked cases (the first is fault 3.5's) and whisper's non-causal
#: encoder and cross attention at the reduced batch
PEAKED = (("hybrid_112", 1, 512, 512, 32, 32, 112, 112, True, 0),
          ("path_64", 2, 2048, 2048, 16, 16, 64, 64, True, 0),
          ("gqa_128_w256", 1, 1024, 1024, 40, 8, 128, 128, True, 256),
          ("mla_192", 1, 512, 512, 16, 16, 192, 128, True, 0),
          ("audio_enc_64", 2, 1500, 1500, 8, 8, 64, 64, False, 0),
          ("audio_cross_64", 2, 128, 1500, 8, 8, 64, 64, False, 0))
#: the paths' shapes, as PEAKED's
TIMED = (("path", 8, 2048, 2048, 16, 16, 64, 64, True, 0),
         ("serve_moe", 8, 2048, 2048, 16, 16, 128, 128, True, 0),
         ("serve_qk", 8, 2048, 2048, 40, 8, 128, 128, True, 0),
         ("serve_mla", 8, 2048, 2048, 128, 128, 192, 128, True, 0),
         ("serve_hybrid", 8, 2048, 2048, 32, 32, 112, 112, True, 0),
         ("serve_audio_enc", 16, 1500, 1500, 8, 8, 64, 64, False, 0),
         ("serve_audio_cross", 16, 128, 1500, 8, 8, 64, 64, False, 0),
         ("serve_vlm", 8, 2048, 2048, 16, 8, 128, 128, True, 0))

GLOBALS = """constexpr int kDumpKeys = %d;
__device__ float k5_dump[kDumpKeys + 8 + 256];
__device__ int k5_dump_at[2] = {-1, -1};

""" % KEYS
AT_SCORES = ("    // scale, then mask where some key of the tile is hidden "
             "from some row\n")
SCORES = """    if (bh == k5_dump_at[0]) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + nb * 8 + 2 * t + (e & 1);
          if ((e < 2 ? qpos0 : qpos1) == k5_dump_at[1] && kp < Sk &&
              kp < kDumpKeys)
            k5_dump[kp] = s[nb][e];
        }
    }
"""
AT_OUT = "  bf16* obase = o + static_cast<size_t>(bh) * Sq * DV + 2 * t;\n"
OUTPUT = """  if (bh == k5_dump_at[0]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if ((i ? qpos1 : qpos0) != k5_dump_at[1]) continue;
      k5_dump[kDumpKeys] = m[i];
      k5_dump[kDumpKeys + 1] = l[i];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        k5_dump[kDumpKeys + 8 + j * 8 + 2 * t] = oacc[j][2 * i] / den[i];
        k5_dump[kDumpKeys + 9 + j * 8 + 2 * t] = oacc[j][2 * i + 1] / den[i];
      }
    }
  }
"""
ACCESS = """
extern "C" int k5_dump_set(int bh, int qpos) {
  const int at[2] = {bh, qpos};
  return static_cast<int>(cudaMemcpyToSymbol(k5_dump_at, at, sizeof at));
}

extern "C" int k5_dump_get(float* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, k5_dump,
                                               sizeof k5_dump));
}
"""


def instrument(text: str) -> str:
    for anchor in ("namespace {\n", AT_SCORES, AT_OUT):
        if text.count(anchor) != 1:
            sys.exit(f"k5_peaked_dump: anchor {anchor!r} not found once")
    text = text.replace("namespace {\n", GLOBALS + "namespace {\n", 1)
    text = text.replace(AT_SCORES, SCORES + AT_SCORES)
    text = text.replace(AT_OUT, AT_OUT + OUTPUT)
    return text + ACCESS


def build(sources):
    """{(i, dumped): library path}, one nvcc a library, all together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, src in enumerate(sources):
        text = Path(src).read_text()
        for dumped in (False, True):
            cu = OUT / f"s{i}{'_dump' if dumped else ''}.cu"
            cu.write_text(instrument(text) if dumped else text)
            so = cu.with_suffix(".so")
            procs[i, dumped] = (so, subprocess.Popen(
                [backend._nvcc(), *backend.NVCC_FLAGS, "-o", str(so),
                 str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k5_peaked_dump: nvcc failed on {key}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[key] = lib
    return libs


def launch(lib, q, k, v, H, K, causal, window=0):
    """K5 of ``lib`` on the (B·H, S, D) layout."""
    BH, Sq, Dk = q.shape
    Sk, Dv = v.shape[1:]
    out = torch.empty((BH, Sq, Dv), dtype=q.dtype, device=q.device)
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, BH, Sq,
        Sk, H, K, Dk, Dv, int(causal), window, Dk ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        sys.exit(f"k5_peaked_dump: launch failed ({rc})")
    return out


def inputs(B, Sq, Sk, H, K, Dk, Dv, seed, dev):
    """As the card test's ``_flash_inputs`` (q x 8), on the (B·H, S, D)
    layout; Sq != Sk draws q from its own rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
               for s in ((B, Sq, H, Dk), (B, Sk, K, Dk), (B, Sk, K, Dv)))
    q = (q.float() * 8).to(torch.bfloat16)
    flat = lambda x: x.transpose(1, 2).contiguous().view(
        -1, x.shape[1], x.shape[3])
    return flat(q), flat(k), flat(v)


def ratio(got, want):
    """|got - want| over the allowance, elementwise (f32)."""
    return ((got.float() - want.float()).abs()
            / (ATOL + RTOL * want.float().abs()))


def plain_f32(q, k, v, H, K, causal, window=0):
    """The plain version's arithmetic (``kernels/ref.flash_attention``)
    without its last rounding to bf16: the f32 scores and output."""
    BH, Sq, Dk = q.shape
    G = H // K
    bh = torch.arange(BH, device=q.device)
    kv = (bh // H) * K + (bh % H) // G
    s = torch.einsum("bqd,bkd->bqk", q.float() * Dk ** -0.5, k.float()[kv])
    if causal or window:
        s = s.masked_fill(~attention_mask(
            torch.arange(Sq, device=q.device),
            torch.arange(k.shape[1], device=q.device), causal, window),
            ref.NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()[kv])
    return s, o / l.clamp_min(1e-30)


def bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().double().numpy()


def split_terms(lib, case, seed, dev, where=None):
    """The error of the worst element of ``case`` split into its terms."""
    name, B, Sq, Sk, H, K, Dk, Dv, causal, window = case
    q, k, v = inputs(B, Sq, Sk, H, K, Dk, Dv, seed, dev)
    got = launch(lib, q, k, v, H, K, causal, window)
    s_plain, o_plain = plain_f32(q, k, v, H, K, causal, window)
    want = o_plain.to(torch.bfloat16)
    r = ratio(got, want)
    if where is None:
        where = tuple(int(i) for i in np.unravel_index(
            int(r.argmax()), r.shape))
    bh, qpos, d = where
    torch.cuda.synchronize()
    if lib.k5_dump_set(bh, qpos):
        sys.exit("k5_peaked_dump: dump_set failed")
    launch(lib, q, k, v, H, K, causal, window)
    torch.cuda.synchronize()
    dump = np.zeros(KEYS + 8 + 256, np.float32)
    if lib.k5_dump_get(dump.ctypes.data_as(ctypes.c_void_p)):
        sys.exit("k5_peaked_dump: dump_get failed")
    lib.k5_dump_set(-1, -1)
    G = H // K
    kvh = (bh // H) * K + (bh % H) // G
    n = qpos + 1 if causal else Sk                 # keys [lo, n) visible
    lo = max(0, qpos - window + 1) if window else 0
    qr = q[bh, qpos].double().cpu().numpy()
    kr = k[kvh, lo:n].double().cpu().numpy()
    vr = v[kvh, lo:n].double().cpu().numpy()
    scale = Dk ** -0.5
    raw = kr @ qr                                  # exact: bf16 products
    s_exact = raw * scale
    c = np.float32(np.float32(scale) * np.float32(LOG2E))
    x_kernel = (dump[lo:n] * c).astype(np.float32)   # in log2 units
    s_kernel = dump[lo:n].astype(np.float64) * scale
    s_pl = s_plain[bh, qpos, lo:n].double().cpu().numpy()

    def o_of(s):
        p = np.exp(s - s.max())
        return float(p @ vr[:, d] / p.sum())

    o_exact = o_of(s_exact)
    o_sk, o_sp = o_of(s_kernel), o_of(s_pl)
    # P's split from the kernel's own scores, tile by tile as the kernel
    # walks them (running max in the log2 domain), PV and l in f64
    m, l, acc = -1e30, 0.0, 0.0
    for k0 in range(0, n - lo, 64):
        x = x_kernel[k0:k0 + 64].astype(np.float64)
        m_new = max(m, float(x.max()))
        corr = 2.0 ** (m - m_new)
        p = np.exp2(x - m_new).astype(np.float32)
        hi = bf16(p)
        low = bf16(p.astype(np.float64) - hi)
        l = l * corr + float(p.astype(np.float64).sum())
        acc = acc * corr + float((hi + low) @ vr[k0:k0 + 64, d])
        m = m_new
    o_split = acc / l
    o_kernel32 = float(dump[KEYS + 8 + d])
    o_plain32 = float(o_plain[bh, qpos, d])
    top = np.argsort(-s_exact)[:4]
    terms = {
        "element": [bh, qpos, d], "seed": seed,
        "ratio": float(r[bh, qpos, d]),
        "got_bf16": float(got[bh, qpos, d]),
        "plain_bf16": float(want[bh, qpos, d]),
        "exact": o_exact,
        "allowance": ATOL + RTOL * abs(float(want[bh, qpos, d])),
        "top_keys": {int(j) + lo: {"s_exact": float(s_exact[j]),
                              "kernel_err": float(s_kernel[j] - s_exact[j]),
                              "plain_err": float(s_pl[j] - s_exact[j]),
                              "v": float(vr[j, d])} for j in top},
        "S_err_max": {"kernel": float(np.abs(s_kernel - s_exact).max()),
                      "plain": float(np.abs(s_pl - s_exact).max())},
        "S_err_mean_signed_over_|s|>10": {
            "kernel": float((s_kernel - s_exact)[np.abs(s_exact) > 10]
                            .mean()),
            "plain": float((s_pl - s_exact)[np.abs(s_exact) > 10].mean())},
        "O_from_S_minus_exact": {"kernel": o_sk - o_exact,
                                 "plain": o_sp - o_exact},
        "after_S": {"kernel": o_kernel32 - o_sk,
                    "plain": o_plain32 - o_sp},
        "two_term_split_emulated": {"kernel": o_split - o_sk},
        "output_rounding": {
            "kernel": float(got[bh, qpos, d]) - o_kernel32,
            "plain": float(want[bh, qpos, d]) - o_plain32},
        "total_minus_exact": {"kernel": float(got[bh, qpos, d]) - o_exact,
                              "plain": float(want[bh, qpos, d]) - o_exact},
        "m_l": [float(dump[KEYS]), float(dump[KEYS + 1])],
    }
    return terms, where


def exact(q, k, v, H, K, causal, window=0):
    """The attention in f64 from the same bf16 q, k, v (f32 result)."""
    BH, Sq, Dk = q.shape
    bh = torch.arange(BH, device=q.device)
    kv = (bh // H) * K + (bh % H) // (H // K)
    s = torch.einsum("bqd,bkd->bqk", q.double(), k.double()[kv]) \
        * Dk ** -0.5
    if causal or window:
        s = s.masked_fill(~attention_mask(
            torch.arange(Sq, device=q.device),
            torch.arange(k.shape[1], device=q.device), causal, window),
            float("-inf"))
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, dim=-1),
                        v.double()[kv]).float()


def peaked(lib, dev, seeds):
    """Per case and seed: the kernel's worst error over the allowance
    against the plain version (the card test's check), and the kernel's
    and the plain version's (both rounded to bf16) against the f64 value,
    each over the allowance at that value."""
    rows = {}
    for case in PEAKED:
        for seed in seeds:
            name, B, Sq, Sk, H, K, Dk, Dv, causal, window = case
            q, k, v = inputs(B, Sq, Sk, H, K, Dk, Dv, seed, dev)
            got = launch(lib, q, k, v, H, K, causal, window)
            want = plain_f32(q, k, v, H, K, causal, window)[1].to(
                torch.bfloat16)
            r = ratio(got, want)
            ex = exact(q, k, v, H, K, causal, window)
            rows[f"{name}/seed{seed}"] = {
                "worst_ratio": float(r.max()),
                "over": int((r > 1).sum()), "of": r.numel(),
                "kernel_vs_exact": float(ratio(got, ex).max()),
                "plain_vs_exact": float(ratio(want, ex).max())}
            del q, k, v, got, want, r, ex
    return rows


def timed(libs, dev):
    """ms of each clean copy at each path shape, in turns A B B A."""
    times = {}
    for case in TIMED:
        name, B, Sq, Sk, H, K, Dk, Dv, causal, window = case
        gen = torch.Generator(device=dev).manual_seed(2)
        q, k, v = (torch.randn((B * n, S, D), generator=gen, device=dev)
                   .to(torch.bfloat16)
                   for n, S, D in ((H, Sq, Dk), (K, Sk, Dk), (K, Sk, Dv)))
        order = list(range(len(libs))) + list(range(len(libs)))[::-1]
        got = {i: [] for i in range(len(libs))}
        for i in order:
            fn = lambda: launch(libs[i], q, k, v, H, K, causal, window)
            for _ in range(3):
                fn()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20):
                fn()
            b.record()
            torch.cuda.synchronize()
            got[i].append(a.elapsed_time(b) / 20)
        times[name] = got
        print(f"k5 time {name}: " + "; ".join(
            f"source {i}: {', '.join(f'{t * 1e3:.1f}' for t in ts)} us"
            for i, ts in got.items()), flush=True)
    return times


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=None,
                    help="a copy of flash_attention.cu (repeatable; "
                         "default: the port's)")
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    sources = args.source or [str(ROOT / "src/repro_torch/kernels/csrc/"
                                  "flash_attention.cu")]
    if not torch.cuda.is_available():
        sys.exit("k5_peaked_dump: needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build(sources)
    result, where = {"sources": sources}, None
    for i, src in enumerate(sources):
        rows = peaked(libs[i, False], dev, args.seeds)
        terms, where = split_terms(libs[i, True], PEAKED[0], 0, dev, where)
        worst = max(rows, key=lambda n: rows[n]["worst_ratio"])
        name, seed = worst.split("/seed")
        own, _ = split_terms(libs[i, True], next(
            c for c in PEAKED if c[0] == name), int(seed), dev)
        own["case"] = worst
        result[f"source{i}"] = {"peaked": rows, "terms": terms,
                                "worst_terms": own}
        print(f"source {i} ({src}):", flush=True)
        for name, row in rows.items():
            print(f"  peaked {name}: worst error/allowance "
                  f"{row['worst_ratio']:.4f}, {row['over']} of {row['of']} "
                  f"over; against f64: kernel {row['kernel_vs_exact']:.4f}"
                  f", plain {row['plain_vs_exact']:.4f}", flush=True)
        print("  terms at " + json.dumps(terms), flush=True)
        print("  its worst element's terms " + json.dumps(own), flush=True)
    if not args.no_time:
        result["times_ms"] = timed([libs[i, False]
                                    for i in range(len(sources))], dev)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "k5_peaked_dump.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps({"ok": True}))


if __name__ == "__main__":
    main()
