"""Which operations of the fused per-frame steps and the rare paths' stages
can be captured into a CUDA graph on this card, and the closest-rotation
kernel against its twin.

    python3 -m pli_slam_tpu_torch.utils.capture_probe [--only NAME]

Each probe runs in a process of its own (a refused capture can leave the
stream unusable): the operation is run once eagerly on a side stream, then
captured with `torch.cuda.graph` and replayed. It prints one line per
probe, `ok` or the first line of the error, then the kernel check (largest
difference from `torch.linalg.svd`'s closest rotation, agreement of the
sign of det, time per call of both). Needs a GPU.

The conditional-node cases (`CONDITIONAL`) hold what the fused steps'
graphs need: first whether this torch has PyTorch's own route
(`CUDAGraph.begin_capture_to_if_node`) and which allocator hooks it
offers, then, through the port's route (ops.kernels.conditional.if_node,
`csrc/cond_node.cu`), an IF node whose body allocates and writes a buffer,
replayed with its predicate set by a kernel of the graph to true and then
to false, and the fused step's operations inside IF bodies (the gated
match, the closest-rotation kernel, the dense solves of GN and windowed BA,
a matrix product, a copy), each result checked against an eager run,
and the same without the priming capture (`conditional._prime`) after a
plain capture of a solve; last, loop-closing trackers built under graphs
one after another, each dropped before the next: which of them capture,
the streams each capture used against the IF bodies' stream, the device
memory each tracker leaves reserved after its drop, and (`"what dropped
trackers leave"`) where what stays allocated was allocated (ROADMAP
queue 3 A8).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import subprocess
import sys
import traceback

import torch


def _probes(dev):
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    def spd(b, n):
        a = rnd(b, n, n)
        return a @ a.transpose(-1, -2) + n * torch.eye(n, device=dev)

    idx0 = torch.tensor(3, device=dev)
    pinned = torch.empty(3, dtype=torch.int32).pin_memory()
    vec = rnd(64)
    ints = torch.arange(3, dtype=torch.int32, device=dev)
    return {
        "linalg.svd[16,3,3]": lambda: torch.linalg.svd(rnd_fixed["r16"], full_matrices=False),
        "linalg.det[16,3,3]": lambda: torch.linalg.det(rnd_fixed["r16"]),
        "linalg.solve_ex[6x6]": lambda: torch.linalg.solve_ex(rnd_fixed["s6"], rnd_fixed["b6"]),
        "linalg.solve_ex[60x60]": lambda: torch.linalg.solve_ex(rnd_fixed["s60"], rnd_fixed["b60"]),
        "linalg.solve_ex[150x150]": lambda: torch.linalg.solve_ex(rnd_fixed["s150"], rnd_fixed["b150"]),
        "linalg.inv_ex[9,9,9]": lambda: torch.linalg.inv_ex(rnd_fixed["s9"]),
        "linalg.cholesky_ex[9,9,9]": lambda: torch.linalg.cholesky_ex(rnd_fixed["s9"]),
        "linalg.inv[3,3]": lambda: torch.linalg.inv(rnd_fixed["s3"]),
        "index with 0-d tensor": lambda: vec[idx0] + 1,
        "index_put with 0-d tensor": lambda: vec.clone().index_put_((idx0,), torch.ones((), device=dev)),
        "copy to pinned (non_blocking)": lambda: pinned.copy_(ints, non_blocking=True),
        "torch.tensor(list, device)": lambda: torch.tensor([1.0, 2.0], device=dev) + 1,
        "sort stable / topk / searchsorted": lambda: (torch.sort(vec, stable=True), torch.topk(vec, 5),
                                                      torch.searchsorted(torch.sort(vec)[0], vec)),
        "rot3 kernel": lambda: _rot3(rnd_fixed["r16"]),
        # the rare paths (relocalization, loop verification): Horn's 4x4 eigenproblem over the RANSAC
        # hypotheses, the mono PnP DLT's 12x12 SVD, the relocalization's Hamming matrix against the
        # whole point store, the loop's scene-scaled threshold
        "linalg.eigh[256,4,4]": lambda: torch.linalg.eigh(rnd_fixed["e256"]),
        "linalg.svd[256,12,12]": lambda: torch.linalg.svd(rnd_fixed["a256"]),
        "hamming_matrix[1200x16384]": lambda: _hamming(rnd_fixed["d1200"], rnd_fixed["d16384"]),
        "indexing.nanmedian[4096]": lambda: _nanmedian(rnd_fixed["m4096"], rnd_fixed["k4096"]),
        # the two-view initialization (256 F and 256 H hypotheses: the 8-point and 4-point A^T A, E's SVD, the
        # proper-rotation signs, H^-1) and the inertial-only MAP problem's dense solve (9 + 3 x 32 unknowns)
        "linalg.det[256,3,3]": lambda: torch.linalg.det(rnd_fixed["r256"]),
        "linalg.inv_ex[256,3,3]": lambda: torch.linalg.inv_ex(rnd_fixed["r256"]),
        "linalg.eigh[512,9,9]": lambda: torch.linalg.eigh(rnd_fixed["e512"]),
        "linalg.solve_ex[105x105]": lambda: torch.linalg.solve_ex(rnd_fixed["s105"], rnd_fixed["b105"]),
    }, rnd, spd


rnd_fixed: dict = {}


def _hamming(a, b):
    from pli_slam_tpu_torch.ops.matching import hamming_matrix
    return hamming_matrix(a, b)


def _nanmedian(d, mask):
    from pli_slam_tpu_torch.ops.indexing import nanmedian
    return nanmedian(d, mask)


def _pm1(dev, n, g):
    return (torch.randint(0, 2, (n, 256), generator=g, dtype=torch.int8) * 2 - 1).to(dev)


def _rot3(x):
    from pli_slam_tpu_torch.ops.kernels import rot3
    return rot3.closest_rotation_cuda(x)


def conditional_route() -> str:
    """Whether this torch has PyTorch's own IF-node route, and the allocator's pool hooks it offers."""
    g = torch.cuda.CUDAGraph
    missing = [n for n in ("get_currently_capturing_graph", "begin_capture_to_if_node",
                           "end_capture_to_conditional_node") if not hasattr(g, n)]
    hooks = sorted(n for n in dir(torch._C) if "AllocateCurrent" in n or n in ("_cuda_endAllocateToPool",
                                                                               "_cuda_releasePool"))
    own = "torch's route: " + ("present" if not missing else "missing " + ", ".join(missing))
    return f"{own}; allocator hooks: {', '.join(hooks)}"


def _capture_if(dev, before, body, flag):
    """A graph that runs `before()` and then `body()` inside an IF node on `flag > 0` (flag: an int32 CUDA
    scalar read by a kernel of the graph at each replay)."""
    from pli_slam_tpu_torch.ops.kernels.conditional import BodyPool, if_node, ready
    ready(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    bodies = BodyPool(dev, graph)
    with torch.cuda.stream(side):
        before()
        body()  # warm-up: builds, handles, the kernel's per-shape plans
        torch.cuda.synchronize(dev)
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            before()
            with if_node(flag > 0, bodies):
                body()
    torch.cuda.current_stream(dev).wait_stream(side)
    return graph


def _replay_both(graph, flag, dev, check_true, check_false) -> str:
    for value, check in ((1, check_true), (0, check_false), (1, check_true)):
        flag.fill_(value)
        graph.replay()
        torch.cuda.synchronize(dev)
        bad = check()
        if bad:
            return f"predicate {bool(value)}: {bad}"
    return "ok"


def conditional_alloc(dev) -> str:
    """An IF body that allocates a buffer, writes it and copies it out."""
    x = torch.arange(1, 1025, dtype=torch.float32, device=dev)
    out = torch.empty(1024, device=dev)
    flag = torch.zeros((), dtype=torch.int32, device=dev)

    def body():
        buf = torch.empty(1024, device=dev)  # allocated inside the body: from the capture's pool
        torch.mul(x, 2.0, out=buf)
        buf.add_(1.0)
        out.copy_(buf)

    graph = _capture_if(dev, lambda: out.fill_(-1.0), body, flag)
    # memory the caching allocator hands out after the capture: a body whose buffer was not the pool's writes here
    others = [torch.full((1024,), 7.0, device=dev) for _ in range(8)]
    want = 2 * x + 1

    def held():
        if not torch.equal(out, want):
            return "body's result wrong"
        return None if all(bool((o == 7.0).all()) for o in others) else "the body wrote outside its pool"

    return _replay_both(graph, flag, dev, held, lambda: None if bool((out == -1.0).all()) else "body ran")


def conditional_kernels(dev) -> str:
    """The fused step's operations inside two IF bodies on complementary predicates, their results merged
    into one set of output buffers (as the keyframe branch with and without windowed BA)."""
    from pli_slam_tpu_torch.ops.kernels import hamming, rot3
    from pli_slam_tpu_torch.ops.kernels.conditional import BodyPool, if_node, last_body_census, ready
    ready(dev)
    g = torch.Generator().manual_seed(3)
    fdesc, sdesc = _pm1(dev, 1200, g), _pm1(dev, 4096, g)
    fuv, suv = (torch.rand(1200, 2, generator=g) * 600).to(dev), (torch.rand(4096, 2, generator=g) * 600).to(dev)
    fval, sval = torch.ones(1200, dtype=torch.bool, device=dev), torch.rand(4096, generator=g).to(dev) > 0.1
    R = (torch.eye(3) + 1e-3 * torch.randn(16, 3, 3, generator=g)).to(dev)
    A = (lambda a: a @ a.T + 150 * torch.eye(150))(torch.randn(150, 150, generator=g)).to(dev)
    b = torch.randn(150, generator=g).to(dev)
    H6 = (lambda a: a @ a.transpose(-1, -2) + 6 * torch.eye(6))(torch.randn(4, 6, 6, generator=g)).to(dev)
    g6 = torch.randn(4, 6, generator=g).to(dev)
    radius = torch.full((), 40.0, device=dev)

    def run(heavy: bool):
        idx, best, ok = hamming.gated_match(fdesc, fuv, fval, sdesc, suv, sval, radius)
        Rn = rot3.closest_rotation(R)
        d6 = torch.linalg.solve_ex(H6, g6).result
        x = torch.linalg.solve_ex(A, b).result if heavy else torch.zeros(150, device=dev)
        return idx, best, ok, Rn, d6, x, Rn @ Rn.transpose(-1, -2)

    want = {heavy: [t.clone() for t in run(heavy)] for heavy in (True, False)}
    outs = [torch.empty_like(t) for t in want[True]]
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    bodies = BodyPool(dev, graph)
    with torch.cuda.stream(side):
        run(True), run(False)
        torch.cuda.synchronize(dev)
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            pred = flag > 0
            for p, heavy in ((pred, True), (~pred, False)):
                with if_node(p, bodies):
                    for o, t in zip(outs, run(heavy)):
                        o.copy_(t)
    torch.cuda.current_stream(dev).wait_stream(side)

    def same(heavy):
        return lambda: next((f"output {i} differs" for i, (o, w) in enumerate(zip(outs, want[heavy]))
                             if not torch.equal(o, w)), None)

    result = _replay_both(graph, flag, dev, same(True), same(False))
    return result if result != "ok" else f"ok (the second body's nodes: {last_body_census()})"


def conditional_unprimed(dev) -> str:
    """The IF bodies' case above without `conditional._prime`, after a plain
    capture of a dense solve (the process's first captured solve): whether
    the bodies' solves still come as graph memory nodes, which CUDA refuses
    in a body, now that the bodies' stream is the port's own."""
    from pli_slam_tpu_torch.ops.kernels import conditional

    conditional._prime = lambda *args: None
    conditional.ready(dev)
    a, b = torch.eye(48, device=dev) * 2.0, torch.ones(48, device=dev)
    here, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
    side.wait_stream(here)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        torch.linalg.solve_ex(a, b)
        torch.cuda.synchronize(dev)
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            torch.linalg.solve_ex(a, b)
    here.wait_stream(side)
    graph.replay()
    return conditional_kernels(dev)


class StreamLog:
    """The streams of every capture `frontend.graphs.capture_graph` makes
    while it is installed (`with StreamLog(dev) as log:`), read from the
    outside so that it runs on earlier trees too: the stream its warm-up ran
    on and the stream it captured on (the current stream when the body is
    called), whether it failed, and the IF bodies' stream (the device's
    `ops.kernels.conditional._streams` entry, `_body_streams` on earlier
    trees)."""

    def __init__(self, dev):
        self.dev, self.rows = dev, []

    def __enter__(self):
        from pli_slam_tpu_torch.frontend import graphs

        self._graphs, self._orig = graphs, graphs.capture_graph
        dev = self.dev

        def capture_graph(device, pool, what, body, *args, **kwargs):
            row = {"what": what, "warm": None, "side": None, "error": None}
            self.rows.append(row)

            def logged(commit):
                row["side" if commit else "warm"] = torch.cuda.current_stream(dev).cuda_stream
                return body(commit)
            try:
                return self._orig(device, pool, what, logged, *args, **kwargs)
            except Exception as exc:
                row["error"] = (str(exc).strip().splitlines() or [type(exc).__name__])[0][:160]
                raise
        graphs.capture_graph = capture_graph
        return self

    def __exit__(self, *exc):
        self._graphs.capture_graph = self._orig

    def body(self) -> int | None:
        from pli_slam_tpu_torch.ops.kernels import conditional
        if hasattr(conditional, "_body_streams"):  # a tree before the port had streams of its own
            stream = conditional._body_streams.get(self.dev.index)
        else:
            roles = conditional._streams.get(self.dev.index)
            stream = None if roles is None else roles.body
        return None if stream is None else stream.cuda_stream

    def report(self, rows: list) -> str:
        """Captures, distinct side / warm handles, and each capture whose side
        or warm stream is the body stream (with its error, if it failed)."""
        body = self.body()
        hit = [f"{r['what']} ({'side' if r['side'] == body else 'warm'}"
               + (f", failed: {r['error']}" if r["error"] else "") + ")"
               for r in rows if body is not None and body in (r["side"], r["warm"])]
        failed = [f"{r['what']}: {r['error']}" for r in rows if r["error"] and body not in (r["side"], r["warm"])]
        handles = {h for r in rows for h in (r["side"], r["warm"]) if h is not None}
        return (f"{len(rows)} captures on {len(handles)} streams, body stream {body:#x}; on the body stream: "
                f"{hit or 'none'}" + (f"; failed elsewhere: {failed}" if failed else "")) if body is not None else \
            f"{len(rows)} captures, no body stream yet"


def _reserved_after_collect(dev) -> int:
    import gc

    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(dev)


def _pinned_bytes() -> str:
    """The caching host allocator's pinned bytes (the trackers' uploads), where this torch reports them."""
    stats = getattr(torch.cuda, "host_memory_stats", lambda: {})()
    return ", ".join(f"{k} {v}" for k, v in sorted(stats.items()) if k.endswith("bytes.current")) or "not reported"


def trackers_in_a_row(dev, n: int = 5) -> str:
    """Loop-closing trackers (phase 6a's configuration) built under graphs one
    after another, each tracking 12 frames and then dropped and collected
    before the next: which of them capture (ROADMAP queue 3 A8), the streams
    of each tracker's captures against the IF bodies' stream (`StreamLog`),
    and the device memory each leaves reserved after its drop,
    `gc.collect()` and `torch.cuda.empty_cache()`."""
    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.utils import profile, synthetic

    from pli_slam_tpu_torch.ops.kernels import conditional

    cfg, cam = profile.loop_config(), profile.slice_camera()
    frames = list(synthetic.make_sequence(cam, 12, dev, fps=cfg.fps, traj=synthetic.Trajectory(**profile.FLAGSHIP_TRAJ)))
    base = _reserved_after_collect(dev)
    conditional.ready(dev)  # once a process: the port's streams, the priming graph
    torch.mm(frames[0]["img_l"], frames[0]["img_l"].T)  # and the tracking stream's cuBLAS workspace
    print(f"before the first tracker: {_reserved_after_collect(dev) - base:+d} B for the process (the port's "
          f"streams, the priming graph, cuBLAS's workspace of the current stream)", flush=True)
    out = []
    with StreamLog(dev) as log:
        for i in range(n):
            before, k = _reserved_after_collect(dev), len(log.rows)
            try:
                tracker = Tracker(cam, cfg, dev)
                for fr in frames:
                    tracker.process(fr["img_l"], fr["img_r"], fr["t"])
                result = "ok"
            except Exception as exc:  # the refusal is the result
                result = (str(exc).strip().splitlines() or [type(exc).__name__])[0][:120]
            tracker = None
            left = _reserved_after_collect(dev) - before
            print(f"tracker {i}: {result}; reserved {before} B before it, {left:+d} B left after its drop, "
                  f"pinned host memory {_pinned_bytes()}; {log.report(log.rows[k:])}", flush=True)
            out.append(f"{i}: {result} ({left:+d} B)")
    return "; ".join(out)


def _repo_frames(frames: list, n: int = 4) -> str:
    """The innermost `n` frames of an allocation's Python stack that lie in
    the port, and the torch frame that allocated."""
    ours = [f for f in frames if "pli_slam_tpu_torch" in f.get("filename", "")]
    torch_ = next((f for f in frames if "torch" in f.get("filename", "") and "pli_slam" not in f["filename"]), None)
    names = [f"{f['filename'].split('pli_slam_tpu_torch/')[-1]}:{f['line']} {f['name']}" for f in ours[:n]]
    return " < ".join(([f"torch {torch_['name']}"] if torch_ else []) + names) or "no Python frame"


def tracker_leftovers(dev, n: int = 6) -> str:
    """`trackers_in_a_row` with the caching allocator's history on: after the
    last drop, every segment that still holds an allocated block, by pool,
    with each such block's size and where it was allocated (the port's
    innermost frames), grouped by that place."""
    import collections

    torch.cuda.memory._record_memory_history(max_entries=2_000_000, stacks="python")
    result = trackers_in_a_row(dev, n)
    _reserved_after_collect(dev)
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    held = collections.defaultdict(lambda: [0, 0, set()])  # place -> [blocks, bytes, segments' pools]
    for seg in snap["segments"]:
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                h = held[_repo_frames(b.get("frames", []))]
                h[0] += 1
                h[1] += b["size"]
                h[2].add((str(seg.get("segment_pool_id")), seg["total_size"]))
    segs = [(str(seg.get("segment_pool_id")), seg["total_size"], sum(b["size"] for b in seg["blocks"]
                                                                      if b["state"] == "active_allocated"))
            for seg in snap["segments"]]
    print(f"segments left: {len(segs)}, {sum(t for _, t, _ in segs)} B reserved, {sum(a for _, _, a in segs)} B "
          f"allocated; by pool: {sorted(collections.Counter(p for p, _, _ in segs).items())}", flush=True)
    for place, (blocks, size, pools) in sorted(held.items(), key=lambda kv: -kv[1][1]):
        pinned = sum(t for _, t in pools)
        print(f"  {blocks} blocks, {size} B, in segments of {pinned} B (pools {sorted(p for p, _ in pools)}): "
              f"{place}", flush=True)
    return result


CONDITIONAL = {"route": lambda dev: conditional_route(),
               "IF body allocates": conditional_alloc,
               "kernels and solves in IF bodies": conditional_kernels,
               "solves in IF bodies, unprimed": conditional_unprimed,
               "trackers in a row": trackers_in_a_row,
               "what dropped trackers leave": tracker_leftovers}


def run_probe(name: str) -> str:
    dev = torch.device("cuda", 0)
    if name in CONDITIONAL:
        try:
            return CONDITIONAL[name](dev)
        except Exception as exc:  # the refusal is the result; where it came from on stderr
            traceback.print_exc()
            return (str(exc).strip().splitlines() or [type(exc).__name__])[0][:200]
    probes, rnd, spd = _probes(dev)
    rnd_fixed.update(r16=rnd(16, 3, 3), s6=spd(1, 6), b6=rnd(1, 6), s60=spd(1, 60), b60=rnd(1, 60),
                     s150=spd(1, 150), b150=rnd(1, 150), s9=spd(9, 9), s3=spd(1, 3)[0],
                     e256=spd(256, 4), a256=rnd(256, 12, 12), m4096=rnd(4096).abs(), k4096=rnd(4096) > 0,
                     r256=rnd(256, 3, 3), e512=spd(512, 9), s105=spd(1, 105), b105=rnd(1, 105))
    g = torch.Generator().manual_seed(2)
    rnd_fixed.update(d1200=_pm1(dev, 1200, g), d16384=_pm1(dev, 16384, g))
    fn = probes[name]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(side):
            fn()
            torch.cuda.synchronize()
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        return "ok"
    except Exception as exc:  # the refusal is the result
        return (str(exc).strip().splitlines() or [type(exc).__name__])[0][:200]


def kernel_check() -> dict:
    from pli_slam_tpu_torch.ops.kernels import rot3
    dev = torch.device("cuda", 0)
    build_s = rot3.build()
    g = torch.Generator().manual_seed(1)
    out = {"build_s": build_s}
    for n in (1, 16, 4096):
        # near rotations (what the solvers hand it), arbitrary matrices and reflections
        base = rot3.closest_rotation_reference(torch.randn(n, 3, 3, generator=g))
        cases = {"near_rotation": base + 1e-3 * torch.randn(n, 3, 3, generator=g),
                 "random": torch.randn(n, 3, 3, generator=g),
                 "reflection": base @ torch.diag(torch.tensor([3.0, 2.0, -1.0]))}  # det < 0, distinct values
        for label, x in cases.items():
            xd = x.to(dev)
            got = rot3.closest_rotation_cuda(xd)
            want = rot3.closest_rotation_reference(xd)
            err = float((got - want).abs().max())
            det_same = bool(torch.equal(torch.sign(torch.linalg.det(got)), torch.sign(torch.linalg.det(want))))
            out[f"{label}[{n}]"] = {"max_abs_err": err, "det_sign_equal": det_same}
    x = rot3.closest_rotation_reference(torch.randn(1, 3, 3, generator=g)).to(dev)
    for label, fn in (("kernel_ms", lambda: rot3.closest_rotation_cuda(x)),
                      ("plain_ms", lambda: rot3.closest_rotation_reference(x))):
        for _ in range(10):
            fn()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        for _ in range(200):
            fn()
        e.record()
        torch.cuda.synchronize()
        out[label] = s.elapsed_time(e) / 200
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", help="run one probe in this process and print its result")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("capture_probe needs a GPU", file=sys.stderr)
        return 2
    if args.only:
        print(run_probe(args.only))
        return 0
    names = list(CONDITIONAL) + list(_probes(torch.device("cuda", 0))[0])

    def one(name):
        proc = subprocess.run([sys.executable, "-m", "pli_slam_tpu_torch.utils.capture_probe", "--only", name],
                              capture_output=True, text=True, timeout=300)
        lines = proc.stdout.strip().splitlines()
        return name, lines[-1] if lines else f"exit {proc.returncode}: {proc.stderr.strip()[-200:]}"

    with cf.ThreadPoolExecutor(4) as pool:
        results = dict(pool.map(one, names))
    for name in names:
        print(f"capture {name}: {results[name]}")
    print(json.dumps({"conditional": {n: results[n] for n in CONDITIONAL},
                      "capture": {n: r for n, r in results.items() if n not in CONDITIONAL},
                      "torch": torch.__version__, "cuda": torch.version.cuda, "rot3": kernel_check()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
