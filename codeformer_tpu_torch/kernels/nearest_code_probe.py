"""Where K3's time goes, on the card.

    python -m codeformer_tpu_torch.kernels.nearest_code_probe [PARENT]

Builds csrc/nearest_code.cu again in variants, each a text edit into a
scratch copy under build/probe_k3/ (the library the port uses is not
touched). With a part taken out (only the full build computes K3; the
others time a part): without the staging (no cp.async: the products
read whatever shared memory holds), without the cluster reduction (no
cluster barriers; rank 0 writes its own candidates), the products alone
(neither), the products without the z loads or without the code loads
from shared memory (values made in registers instead), the FFMA alone
(no loads at all), and the FFMA alone without the per-chunk barrier.
With a design choice changed (these compute K3): chunks of 32, 4 ring
stages, the 4-wide D-step loop rolled or fully unrolled (it is unrolled
twice; and the FFMA alone with it rolled). At each of the token counts in TOKENS (K = 1024,
D = 256, fp32 z, init-scale codebook) it times each beside the full
kernel at the plan's cluster size, the full kernel at every cluster
size, and the fp32 product alone (torch.mm, TF32 off): runs of
back-to-back launches between two CUDA events, the median run. It also
prints how many clusters of each size the card holds at once, the
instruction mix of the K3 kernels (cuobjdump -sass), and the SM clock
and power while the full kernel runs at the largest T. With PARENT, a
checkout of an earlier commit (`git archive <commit>
codeformer_tpu_torch | tar -x -C PARENT`) whose K3 has the earlier C
entry (z, e, e_sq, keys, out, T, K, D, device, stream), its
csrc/nearest_code.cu is built too and timed the way its wrapper called
it: e_sq, the int32 keys pass and the int64 copy included ("call"),
and its C entry alone ("launch"). Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from codeformer_tpu_torch.kernels import build
from codeformer_tpu_torch.ops import vq

TOKENS = (256, 1024, 2048, 4096, 16384)
DIM, CODES = 256, 1024
FP32_FLOPS = 67e12        # the H100 SXM's fp32 peak outside the tensor cores

_STAGE = '    int cs, int n_chunks, int z_row) {\n'
_NO_STAGE = _STAGE + '  if (n_chunks > 0) return;\n'
_SYNC_IN = ("  cluster.sync();      // every rank's keys are in its shared "
            "memory\n")
_SYNC_OUT = ("  cluster.sync();      // rank 0 has read them: the blocks may "
             "exit\n")
_DSMEM = 'for (int r = 1; r < cs; ++r) {'
_Z_LOADS = ('for (int i = 0; i < 8; ++i) load_z4(zs + (tr + 8 * i) * z_ld '
            '+ d, a[i]);')
_CHUNK = 'constexpr int kDk = 64;'
_STAGES = 'constexpr int kStages = 3;'
_UNROLL = '#pragma unroll 2\n    for (int d = 0; d < kHalf; d += 4) {'
_WAIT = ('    cp_async_wait<kStages - 2>();\n'
         '    __syncthreads();   // chunk q is in; every thread is done with '
         'q - 1\n')
# stand-ins that keep the data dependencies, so nothing is optimised away
_NO_Z_LOADS = ('for (int i = 0; i < 8; ++i) a[i][0] = a[i][1] = a[i][2] = '
               'a[i][3] = '
               '__int_as_float(0x3f800000 + ((tr + i + d + q) & 7));')
_E_LOADS = ('        const float4 lo =\n'
            '            *reinterpret_cast<const float4*>(es + (d + k) * '
            'kCodes + 4 * tc);\n'
            '        const float4 hi = *reinterpret_cast<const float4*>(\n'
            '            es + (d + k) * kCodes + 64 + 4 * tc);')
_NO_E_LOADS = ('        const float v = __int_as_float(0x3f800000 + '
               '((tc + k + d) & 7));\n'
               '        const float4 lo = make_float4(v, v, v, v), hi = lo;')


def variants(src: str) -> dict:
    """{name: nearest_code.cu text}, each with a part taken out or a
    design choice changed."""
    for part in (_STAGE, _SYNC_IN, _SYNC_OUT, _DSMEM, _Z_LOADS, _E_LOADS,
                 _CHUNK, _STAGES, _WAIT, _UNROLL):
        if part not in src:
            raise RuntimeError(f'nearest_code.cu changed: {part[:40]!r}')
    no_red = (src.replace(_SYNC_IN, '  __syncthreads();\n')
              .replace(_SYNC_OUT, '')
              .replace(_DSMEM, 'for (int r = cs; r < cs; ++r) {'))
    products = no_red.replace(_STAGE, _NO_STAGE)
    ffma = products.replace(_Z_LOADS, _NO_Z_LOADS).replace(_E_LOADS,
                                                           _NO_E_LOADS)
    roll1 = _UNROLL.replace('unroll 2', 'unroll 1')
    return {'D steps rolled': src.replace(_UNROLL, roll1),
            'D steps fully unrolled': src.replace(
                _UNROLL, _UNROLL.replace('unroll 2', 'unroll')),
            'FFMA only, D steps rolled': ffma.replace(_UNROLL, roll1),
            'chunks of 32': src.replace(_CHUNK, _CHUNK.replace('64', '32')),
            '4 stages': src.replace(_STAGES, _STAGES.replace('3', '4')),
            'FFMA only, no barriers': ffma.replace(_WAIT, ''),
            'no staging': src.replace(_STAGE, _NO_STAGE),
            'no cluster reduction': no_red,
            'products only': products,
            'products, no z loads': products.replace(_Z_LOADS, _NO_Z_LOADS),
            'products, no code loads': products.replace(_E_LOADS,
                                                        _NO_E_LOADS),
            'FFMA only': ffma}


def _compile(jobs) -> dict:
    """[(name, .cu path, entry, argtypes)] -> {name: ctypes function},
    one nvcc each, all started together."""
    procs = []
    for name, src, entry, argtypes in jobs:
        lib = src.with_suffix('.so')
        cmd = [build._nvcc(), *build.NVCC_FLAGS, '-shared', '-o', str(lib),
               str(src)]
        procs.append((name, lib, entry, argtypes, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = {}
    for name, lib, entry, argtypes, proc in procs:
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f'{name}: nvcc failed\n{log[-3000:]}')
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def build_variants(root: Path, parent: Path | None) -> dict:
    src = (build.CSRC / 'nearest_code.cu').read_text()
    jobs = []
    for i, (name, text) in enumerate(variants(src).items()):
        d = root / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / 'nearest_code.cu').write_text(text)
        jobs.append((name, d / 'nearest_code.cu', 'cf_nearest_code',
                     build.SIGNATURES['cf_nearest_code']))
    if parent is not None:
        d = root / 'parent'
        d.mkdir(parents=True, exist_ok=True)
        (d / 'nearest_code.cu').write_text(
            (parent / 'codeformer_tpu_torch' / 'csrc' / 'nearest_code.cu')
            .read_text())
        jobs.append(('parent', d / 'nearest_code.cu', 'cf_nearest_code',
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p]))
    return _compile(jobs)


def time_ms(fn, iters: int = 20, runs: int = 5) -> float:
    """Median per-call ms of runs of back-to-back calls (CUDA events)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return sorted(times)[len(times) // 2]


def checked(name: str, fn, args):
    def run():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f'{name}: launch failed (cudaError {rc})')
    return run


def sass_summary(lib: Path) -> None:
    """Instruction mix of each K3 kernel in `lib` (cuobjdump -sass): the
    count of each opcode, and how many FFMA read an operand from the
    reuse cache."""
    tool = Path(build._nvcc()).parent / 'cuobjdump'
    out = subprocess.run([str(tool), '-sass', str(lib)], capture_output=True,
                         text=True).stdout
    lines = out.splitlines()
    fn, counts, shown = None, {}, False
    for n, line in enumerate(lines + ['Function : end']):
        if not shown and fn and 'nearest_code' in fn and 'FFMA' in line:
            shown = True      # the start of the first product loop
            print('\n'.join(f'    {x.strip()[:110]}'
                            for x in lines[n - 20:n + 60] if '*/' in x),
                  flush=True)
        if 'Function :' in line:
            if fn and 'nearest_code' in fn:
                top = sorted(counts.items(), key=lambda kv: -kv[1])[:12]
                print(f'  SASS {fn[:60]}: ' + ', '.join(
                    f'{k} {v}' for k, v in top), flush=True)
            fn, counts = line.split('Function :')[1].strip(), {}
            continue
        m = re.search(r'/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)'
                      r'(\S*)', line)
        if m:
            op = m.group(2)
            counts[op] = counts.get(op, 0) + 1
            if op == 'FFMA' and '.reuse' in line:
                counts['FFMA with .reuse'] = counts.get('FFMA with .reuse',
                                                        0) + 1


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit('nearest_code_probe: no CUDA device')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    parent = Path(sys.argv[1]) if len(sys.argv) > 1 else None
    fns = build_variants(build.BUILD_ROOT.parent / 'probe_k3', parent)
    lib = build.library()
    print('clusters of 1, 2, 4, 8 blocks resident at once (D = 256): fp32 '
          f'z {vq.resident_clusters(0, False, DIM)}, bf16 z '
          f'{vq.resident_clusters(0, True, DIM)}', flush=True)
    sass_summary(Path(build.build_info['path']))
    g = torch.Generator(device='cuda').manual_seed(0)
    e = (torch.rand(CODES, DIM, generator=g, device='cuda') * 2 - 1) / CODES
    stream = torch.cuda.current_stream().cuda_stream
    for n_tok in TOKENS:
        z = torch.randn(n_tok, DIM, generator=g, device='cuda')
        c = vq.prepare_nearest_code(z, e)
        p = c.plan
        bound = 2 * n_tok * CODES * DIM / FP32_FLOPS * 1e3

        def args(cs, out=c.out):
            return (z.data_ptr(), 0, c.et.data_ptr(), c.e_sq.data_ptr(),
                    out.data_ptr(), n_tok, CODES, DIM, p.kp, p.dp, cs,
                    z.device.index or 0, stream)
        by_cs = {cs: time_ms(checked('full', lib.cf_nearest_code, args(cs)))
                 for cs in vq.CLUSTER_SIZES}
        ms = {'full': by_cs[p.cluster]}
        for name, fn in fns.items():
            if name != 'parent':
                ms[name] = time_ms(checked(name, fn, args(p.cluster)))
        got = vq.nearest_code_indices(z, e)
        ref = vq._nearest_code_ref(z, e)
        if 'parent' in fns:
            fn = fns['parent']
            e_sq = e.square().sum(1)
            keys = torch.empty(n_tok, dtype=torch.int64, device='cuda')
            out = torch.empty(n_tok, dtype=torch.int32, device='cuda')
            ms['parent launch'] = time_ms(checked('parent', fn, (
                z.data_ptr(), e.data_ptr(), e_sq.data_ptr(), keys.data_ptr(),
                out.data_ptr(), n_tok, CODES, DIM, z.device.index or 0,
                stream)))

            def parent_call():
                sq = e.square().sum(1)
                k = torch.empty(n_tok, dtype=torch.int64, device='cuda')
                o = torch.empty(n_tok, dtype=torch.int32, device='cuda')
                rc = fn(z.data_ptr(), e.data_ptr(), sq.data_ptr(),
                        k.data_ptr(), o.data_ptr(), n_tok, CODES, DIM,
                        z.device.index or 0, stream)
                if rc:
                    raise RuntimeError(f'parent: cudaError {rc}')
                return o.long()
            ms['parent call'] = time_ms(parent_call)
            print(f'  parent agrees with the plain version on '
                  f'{float((parent_call() == ref).float().mean()):.6f} of '
                  f'the tokens', flush=True)
        with vq._fp32_matmul():
            ms['fp32 product alone'] = time_ms(lambda: torch.mm(z, e.t()))
        print(f'K3 T={n_tok} K={CODES} D={DIM} fp32 z ({p.tok_tiles} x '
              f'{p.cluster} blocks; bound {bound:.4f} ms, full '
              f'{100 * bound / ms["full"]:.1f}% of it; agrees with the plain '
              f'version on {float((got == ref).float().mean()):.6f} of the '
              f'tokens), ms: '
              + '  '.join(f'{k} {v:.4f}' for k, v in ms.items())
              + '; full kernel by cluster size: ' + '  '.join(
                  f'{cs}: {v:.4f}' for cs, v in by_cs.items()), flush=True)
        if n_tok == TOKENS[-1]:
            clocks_under('the full kernel',
                         checked('full', lib.cf_nearest_code,
                                 args(p.cluster)))


def clocks_under(label: str, fn, seconds: float = 3.0) -> None:
    """Run fn back to back for `seconds` while nvidia-smi samples the SM
    clock and the power."""
    smi = subprocess.Popen(
        ['nvidia-smi', '--query-gpu=clocks.sm,clocks.max.sm,power.draw',
         '--format=csv,noheader', '-lms', '250'], stdout=subprocess.PIPE,
        text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        samples = smi.communicate()[0].strip().splitlines()
    print(f'  clocks under {label}: sm clock, max, power: {samples[2:-1]}',
          flush=True)


if __name__ == '__main__':
    sys.exit(main())
