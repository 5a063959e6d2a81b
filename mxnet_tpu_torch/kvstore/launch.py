"""Start a multi-process distributed training job on this machine (port of
``tools/launch.py``; parity: MXNet's tools/launch.py with the ``local``
launcher).

Usage:
    python -m mxnet_tpu_torch.kvstore.launch -n 2 [--port P] \
        python train.py --epochs 1 ...

Each worker gets DMLC_ROLE=worker, DMLC_WORKER_ID, DMLC_NUM_WORKER,
DMLC_PS_ROOT_URI and DMLC_PS_ROOT_PORT, which
:func:`mxnet_tpu_torch.kvstore.dist.init_distributed` reads (the same
protocol as ``tools/launch.py``, so either launcher starts either
package's workers). When the first worker fails, the others get SIGTERM
and, after the grace period (``MXNET_TPU_TORCH_LAUNCH_GRACE_S``, default
10 s), SIGKILL; a SIGTERM to the launcher is forwarded to every worker.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stderr_tail(path, limit=4096):
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(0, size - limit))
            return fh.read().decode("utf-8", "replace")
    except OSError:
        return ""


def launch_local(n, cmd, port=None, grace=None):
    """Spawn ``n`` local workers; returns the job's exit code.

    Each worker's stderr is captured to a temp file. When the first
    worker exits non-zero, the remaining ranks get SIGTERM and, after
    ``grace`` seconds (env ``MXNET_TPU_TORCH_LAUNCH_GRACE_S``, default 10),
    SIGKILL — survivors would otherwise hang in collectives waiting for
    the dead peer. The failing rank's exit code is returned (not a
    sibling's SIGTERM code) and its stderr tail echoed to this process's
    stderr.

    A SIGTERM delivered to the launcher (a scheduler preemption notice)
    is forwarded to every live worker; ranks still alive after ``grace``
    seconds get SIGKILL."""
    import tempfile
    import time

    port = port or free_port()
    if grace is None:
        grace = float(os.environ.get("MXNET_TPU_TORCH_LAUNCH_GRACE_S", "10"))
    procs = []
    logs = []
    preempt = {"deadline": None}

    def _forward_sigterm(signum, frame):
        preempt["deadline"] = time.monotonic() + grace
        for q in procs:
            if q.poll() is None:
                q.send_signal(signal.SIGTERM)

    try:
        prev_handler = signal.signal(signal.SIGTERM, _forward_sigterm)
    except ValueError:  # not the main thread — skip the trap
        prev_handler = None
    try:
        for rank in range(n):
            env = dict(os.environ)
            env.update({
                "DMLC_ROLE": "worker",
                "DMLC_WORKER_ID": str(rank),
                "DMLC_NUM_WORKER": str(n),
                "DMLC_PS_ROOT_URI": "127.0.0.1",
                "DMLC_PS_ROOT_PORT": str(port),
            })
            log = tempfile.NamedTemporaryFile(
                mode="wb", prefix=f"mxnet_tpu_torch-launch-r{rank}-",
                suffix=".stderr", delete=False)
            logs.append(log.name)
            try:
                procs.append(subprocess.Popen(cmd, env=env, stderr=log))
            finally:
                log.close()
        # Poll all workers: if any dies, tear the whole job down at once
        # (the dmlc tracker does the same).
        rc = 0
        failed_rank = None
        live = list(procs)
        term_deadline = None  # set when SIGTERM was sent; escalate to SIGKILL
        while live:
            for p in list(live):
                code = p.poll()
                if code is None:
                    continue
                live.remove(p)
                if code != 0 and failed_rank is None:
                    failed_rank = procs.index(p)
                    rc = code
                    for q in live:
                        q.send_signal(signal.SIGTERM)
                    term_deadline = time.monotonic() + grace
            deadline = term_deadline or preempt["deadline"]
            if deadline is not None and time.monotonic() > deadline:
                for q in live:
                    if q.poll() is None:
                        q.kill()
            time.sleep(0.1)
        if failed_rank is not None:
            sys.stderr.write(
                f"launch: worker rank {failed_rank} exited with code {rc}; "
                f"stderr tail:\n{_stderr_tail(logs[failed_rank])}\n")
        return rc
    finally:
        if prev_handler is not None:
            try:
                signal.signal(signal.SIGTERM, prev_handler)
            except ValueError:
                pass
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=max(1.0, grace))
            except subprocess.TimeoutExpired:
                p.kill()
        for path in logs:
            try:
                os.unlink(path)
            except OSError:
                pass



def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.kvstore.launch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("--launcher", default="local", choices=["local"],
                    help="only 'local' is provided")
    ap.add_argument("--port", type=int, default=None,
                    help="coordinator port (default: pick a free one)")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")
    cmd = args.command[1:] if args.command[0] == "--" else args.command
    sys.exit(launch_local(args.num_workers, cmd, port=args.port))


if __name__ == "__main__":
    main()
