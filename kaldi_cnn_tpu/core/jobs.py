"""Job-launcher layer: the reference's ``$cmd`` scheduler abstraction.

The reference runs every parallelizable stage as an array job
``$cmd JOB=1:N log/name.JOB.log command...`` through a pluggable shell
launcher (ref: egs/wsj/s5/utils/parallel/run.pl — local fork + wait;
queue.pl — SGE qsub wrapper with the same contract; ssh.pl; SURVEY.md
§1 L8 and §5.8).  The contract is:

  * expand JOB over 1..N,
  * capture each job's output into ``log/name.JOB.log`` with a
    trailing ``# Ended (code C)`` line,
  * wait for all, and fail the stage if any job failed, reporting
    "M / N failed, see log/name.*.log".

Training parallelism in the new framework rides jax.distributed +
collectives (parallel/), so this layer only carries what remains
genuinely embarrassing: per-utterance feature extraction, alignment,
and decoding shards (ref: utils/split_data.sh + steps/decode.sh --nj).
Python callables replace shell commands; launchers are in-process
(threads — NumPy/JAX release the GIL in the hot paths) or subprocess
for shell-command arrays, matching run.pl's fork model.
"""

from __future__ import annotations

import io
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "JobFailure", "Launcher", "SerialLauncher", "LocalLauncher",
    "QueueLauncher", "run_shell_array", "split_scp", "split_even",
]


class JobFailure(RuntimeError):
    """Raised when one or more array jobs fail (run.pl exit semantics)."""

    def __init__(self, name: str, failed: List[int], total: int,
                 log_pattern: str):
        self.failed = failed
        self.total = total
        super().__init__(
            f"{name}: {len(failed)} / {total} jobs failed "
            f"(jobs {failed}); see {log_pattern}")


def _write_log(log_dir: Optional[Path], name: str, job: int, text: str,
               code: int, t0: float) -> None:
    if log_dir is None:
        return
    log_dir.mkdir(parents=True, exist_ok=True)
    with open(log_dir / f"{name}.{job}.log", "w") as fh:
        fh.write(f"# Started at {time.strftime('%c')}\n#\n")
        fh.write(text)
        fh.write(f"\n# Accounting: time={time.time() - t0:.1f}s\n")
        fh.write(f"# Ended (code {code}) at {time.strftime('%c')}\n")


class Launcher:
    """Base ``$cmd``: run fn(job) for job in 1..n, log per job, raise
    JobFailure if any job raised.  Returns {job: result}."""

    def run(self, name: str, n: int, fn: Callable[[int], object],
            log_dir: Optional[str] = None) -> Dict[int, object]:
        raise NotImplementedError

    def _run_one(self, name: str, job: int, fn, log_dir: Optional[Path]):
        buf = io.StringIO()
        t0 = time.time()
        try:
            with redirect_stdout(buf), redirect_stderr(buf):
                result = fn(job)
            _write_log(log_dir, name, job, buf.getvalue(), 0, t0)
            return True, result
        except Exception:
            buf.write(traceback.format_exc())
            _write_log(log_dir, name, job, buf.getvalue(), 1, t0)
            return False, None

    def _collect(self, name: str, n: int, outcomes, log_dir) -> Dict[int, object]:
        results, failed = {}, []
        for job, (ok, result) in outcomes.items():
            if ok:
                results[job] = result
            else:
                failed.append(job)
        if failed:
            pattern = (f"{log_dir}/{name}.*.log" if log_dir
                       else "(no log dir)")
            raise JobFailure(name, sorted(failed), n, pattern)
        return results


class SerialLauncher(Launcher):
    """Jobs one after another in-process (``--nj 1`` semantics,
    deterministic order; the debugging launcher)."""

    def run(self, name, n, fn, log_dir=None):
        ld = Path(log_dir) if log_dir else None
        outcomes = {j: self._run_one(name, j, fn, ld) for j in range(1, n + 1)}
        return self._collect(name, n, outcomes, log_dir)


class LocalLauncher(Launcher):
    """run.pl equivalent: all N jobs concurrently on this host,
    optionally capped (ref: run.pl's implicit fork-all; the cap mirrors
    queue.pl --max-jobs-run)."""

    def __init__(self, max_jobs: Optional[int] = None):
        self.max_jobs = max_jobs

    def run(self, name, n, fn, log_dir=None):
        ld = Path(log_dir) if log_dir else None
        workers = min(n, self.max_jobs) if self.max_jobs else n
        with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
            futs = {j: ex.submit(self._run_one, name, j, fn, ld)
                    for j in range(1, n + 1)}
            outcomes = {j: f.result() for j, f in futs.items()}
        return self._collect(name, n, outcomes, log_dir)


class QueueLauncher(LocalLauncher):
    """queue.pl interface parity.  A real cluster scheduler does not
    exist in this environment; the contract (options accepted, log
    placement, failure reporting) is preserved while execution happens
    locally — the same degradation the reference performs when run.pl
    is substituted for queue.pl (same $cmd contract, SURVEY.md §4
    'distributed testing without a cluster')."""

    def __init__(self, queue_opts: str = "", max_jobs_run: Optional[int] = None,
                 num_threads: int = 1):
        super().__init__(max_jobs=max_jobs_run)
        self.queue_opts = queue_opts
        self.num_threads = num_threads


def run_shell_array(cmd: Sequence[str] | str, n: int, name: str,
                    log_dir: str, max_jobs: Optional[int] = None
                    ) -> None:
    """Shell flavor of the contract: every occurrence of the literal
    ``JOB`` in cmd is replaced by the 1-based job index, each job runs
    as a subprocess (run.pl's fork model), logs land in
    ``log_dir/name.JOB.log``.  Raises JobFailure on any nonzero exit.

    Up to ``max_jobs`` commands run at once (default: all n).  Commands
    that open the GPU must run with ``max_jobs=1`` per card: a JAX
    process reserves most of the card's memory when it starts, so a
    second one on the same card fails for want of memory."""
    ld = Path(log_dir)
    ld.mkdir(parents=True, exist_ok=True)

    def one(job: int) -> int:
        if isinstance(cmd, str):
            c = cmd.replace("JOB", str(job))
            shell = True
        else:
            c = [a.replace("JOB", str(job)) for a in cmd]
            shell = False
        t0 = time.time()
        with open(ld / f"{name}.{job}.log", "w") as fh:
            fh.write(f"# Running: {c}\n# Started at {time.strftime('%c')}\n#\n")
            fh.flush()
            code = subprocess.run(c, shell=shell, stdout=fh,
                                  stderr=subprocess.STDOUT).returncode
            fh.write(f"\n# Accounting: time={time.time() - t0:.1f}s\n")
            fh.write(f"# Ended (code {code}) at {time.strftime('%c')}\n")
        return code

    workers = min(n, max_jobs) if max_jobs else n
    with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        codes = list(ex.map(one, range(1, n + 1)))
    failed = [j for j, c in zip(range(1, n + 1), codes) if c != 0]
    if failed:
        raise JobFailure(name, failed, n, f"{log_dir}/{name}.*.log")


def split_even(items: Sequence, n: int) -> List[List]:
    """Split items into n contiguous, maximally even chunks
    (ref: utils/split_scp.pl default mode, used by utils/split_data.sh).
    Chunks may be empty when n > len(items), matching split_scp.pl's
    behavior of producing short shards rather than failing."""
    n = max(1, n)
    base, extra = divmod(len(items), n)
    out, pos = [], 0
    for j in range(n):
        size = base + (1 if j < extra else 0)
        out.append(list(items[pos:pos + size]))
        pos += size
    return out


def split_scp(scp: Dict[str, object], n: int) -> List[Dict[str, object]]:
    """Split an utterance-keyed mapping into n shards preserving key
    order (the dict is the in-memory scp; ref: utils/split_data.sh)."""
    keys = split_even(list(scp.keys()), n)
    return [{k: scp[k] for k in chunk} for chunk in keys]
