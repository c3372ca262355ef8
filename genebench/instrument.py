"""What the benchmark records inside a run, from its own wrappers around
the port's methods (the port has no spans of its own yet).

Always on: every launch's best path scores, per (call, contig, bin),
captured at `CudaMetaRunner._sweep_mega_multi` and `_sweep_std` (the
launcher thread runs them; the window's calls run one at a time, so the
call a launch belongs to is the one the main thread has open).

With `--trace 1` also: host spans (prep, sweep, finish, fallback, call)
on the host clock, the count of exact re-runs in meta finishing, and the
operands of each DP launch inside the profiled stretch, whose bytes and
operations the roofline metrics count.  Spans stay in memory; the run
reads them after its window.
"""

import threading
import time


def operand(a):
    """What a DP launch's roofline needs of one operand: (shape, bytes,
    the tensor itself when it is an int32 geometry row of at most two
    dimensions, else None), or the value of a plain argument.  Score and
    star tables are not kept: they are large, and only their bytes
    count."""
    if not hasattr(a, "element_size"):
        return a
    keep = a if (str(a.dtype) == "torch.int32" and a.dim() <= 2) else None
    return (tuple(a.shape), a.numel() * a.element_size(), keep)


class Recorder:
    def __init__(self, trace):
        self.trace = trace
        self.lock = threading.Lock()
        self.call = None                # the open call's index
        self.launches = []              # (call, [(ci, bin, score)])
        self.spans = []                 # (name, start, end, thread id)
        self.counts = {"exact_reruns": 0, "winner_contigs": 0}
        self.profiling = False
        self.dp_launches = []           # (kernel, [operand(arg)])
        self._patched = []
        self._local = threading.local()

    # -- the window's bookkeeping ----------------------------------------

    def open_call(self, index):
        self.call = index

    def clear(self):
        with self.lock:
            self.launches.clear()
            self.spans.clear()
            self.dp_launches.clear()
            for k in self.counts:
                self.counts[k] = 0

    def span(self, name, start, end):
        with self.lock:
            self.spans.append((name, start, end, threading.get_ident()))

    def scores(self):
        """{(call, contig index): {bin: device best score}}."""
        out = {}
        for call, items in self.launches:
            for ci, b, s in items:
                out.setdefault((call, ci), {})[b] = s
        return out

    # -- wrappers ----------------------------------------------------------

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._patched.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def _timed(self, name, orig):
        rec = self

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                rec.span(name, t0, time.perf_counter())
        return wrapper

    def install(self, meta_cuda, dp_cuda):
        rec = self
        runner = meta_cuda.CudaMetaRunner

        def mega(orig):
            def wrapper(this, items):
                call = rec.call
                out = orig(this, items)
                best, rows = out[0], out[1]
                pos = {b: i for i, b in enumerate(rows)}
                got = [(it["ci"], b, float(best[k, pos[b]]))
                       for k, it in enumerate(items) for b in it["rows"]]
                with rec.lock:
                    rec.launches.append((call, got))
                return out
            return wrapper

        def std(orig):
            def wrapper(this, work, geoms):
                call = rec.call
                best = orig(this, work, geoms)
                got = [(ci, b, float(best[k]))
                       for k, (ci, b, _key) in enumerate(work)]
                with rec.lock:
                    rec.launches.append((call, got))
                return best
            return wrapper

        sweep = (lambda orig: self._timed("sweep", orig)) if self.trace \
            else (lambda orig: orig)
        self._patch(runner, "_sweep_mega_multi", lambda o: sweep(mega(o)))
        self._patch(runner, "_sweep_std", lambda o: sweep(std(o)))
        if not self.trace:
            return
        self._patch(runner, "_prepare_contig",
                    lambda o: self._timed("prep", o))
        # a contig the mega kernel cannot take: the exact engine's whole
        # sequential sweep on the pool (route "c")
        self._patch(runner, "_produce_fallback",
                    lambda o: self._timed("fallback", o))

        def winner(orig):
            timed = self._timed("finish", orig)

            def wrapper(*args, **kwargs):
                rec._local.in_winner = True
                with rec.lock:
                    rec.counts["winner_contigs"] += 1
                try:
                    return timed(*args, **kwargs)
                finally:
                    rec._local.in_winner = False
            return wrapper

        def rerun(orig):
            def wrapper(*args, **kwargs):
                if getattr(rec._local, "in_winner", False):
                    with rec.lock:
                        rec.counts["exact_reruns"] += 1
                return orig(*args, **kwargs)
            return wrapper

        self._patch(runner, "_produce_winner", winner)
        self._patch(runner, "_score_winner", rerun)

        def dp(kernel):
            def make(orig):
                def wrapper(*args):
                    if rec.profiling:
                        with rec.lock:
                            rec.dp_launches.append(
                                (kernel, [operand(a) for a in args]))
                    return orig(*args)
                return wrapper
            return make

        self._patch(dp_cuda, "mega_dp", dp("dp_mega"))
        self._patch(dp_cuda, "std_dp", dp("dp_std"))

    def uninstall(self):
        while self._patched:
            owner, name, orig = self._patched.pop()
            setattr(owner, name, orig)
