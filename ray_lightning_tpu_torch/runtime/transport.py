"""Worker-process transports: HOW the driver starts a worker on a host
(twin of `ray_lightning_tpu/runtime/transport.py`).

The reference placed workers on cluster nodes through Ray's actor
scheduler (reference ray_ddp.py:106-119) and bootstrapped the rendezvous
with env-var injection (:158-164). Here placement is a pluggable
transport: the WorkerGroup decides WHAT to run (the worker loop, its
rank, the driver's listener address) and the transport decides how a
process running it appears on ``host``.

  * LocalTransport    — a subprocess on the driver's machine.
  * SSHTransport      — ``ssh host -- python -u -`` with the worker
    program piped over stdin: nothing is staged on the remote host for
    the worker loop itself (jobs still import `ray_lightning_tpu_torch`
    and their own modules, so those must be importable there, on the
    interpreter's path or under ``pythonpath``), and the authkey
    travels over the encrypted stdin, never on a command line.
  * LoopbackTransport — the SSH bootstrap without ssh: ``python -u -``
    locally with a scrubbed environment, the same stdin bootstrap and
    the routable listener. The test seam of the cross-host path.

Every transport returns a ``subprocess.Popen`` (for SSH, the local ssh
client: killing it drops the pipes, which the worker sees as EOF).

Only what the group puts in a worker's explicit environment reaches a
remote worker (the group adds the driver's ``CUDA_VISIBLE_DEVICES``);
``host_env`` sets per-host values such as ``RLT_NODE_IP``.

SECURITY: the driver⇄worker channel carries pickled jobs over TCP,
authenticated by a per-launch random 256-bit authkey (the
``multiprocessing.connection`` HMAC challenge) but not encrypted. The
listener binds the one cluster-facing address it advertises; run on a
trusted cluster network, or tunnel the channel (ssh -L) on anything
less.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
from typing import Dict, Optional, Sequence

_WORKER_PATH = os.path.join(os.path.dirname(__file__), "worker.py")
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Transport:
    """Spawn one worker process on ``host``; returns a ``Popen``.

    ``is_remote`` drives address resolution in WorkerGroup and launch:
    remote transports get a listener on the routable address and a
    rendezvous on worker 0's; local ones stay on loopback."""

    is_remote = False

    def spawn(self, *, host: Optional[str], connect: tuple,
              env: Dict[str, str], authkey_hex: str,
              log_path: str) -> subprocess.Popen:
        raise NotImplementedError


class LocalTransport(Transport):
    """Workers as plain subprocesses of the driver. The repository root
    leads the worker's ``PYTHONPATH``, so jobs and factories shipped by
    reference (`pickle`) resolve from any directory the driver ran in."""

    def spawn(self, *, host, connect, env, authkey_hex, log_path):
        driver_host, port, rank, world = connect
        wenv = dict(os.environ)
        wenv.update(env)
        wenv["RLT_WORKER_AUTHKEY"] = authkey_hex
        wenv["PYTHONPATH"] = (
            _REPO_ROOT + os.pathsep + wenv.get("PYTHONPATH", ""))
        with open(log_path, "w") as logf:
            return subprocess.Popen(
                [sys.executable, "-u", _WORKER_PATH,
                 driver_host, str(port), str(rank), str(world)],
                env=wenv, stdout=logf, stderr=subprocess.STDOUT)


def _bootstrap_source(connect: tuple, env: Dict[str, str], authkey_hex: str,
                      pythonpath: Sequence[str]) -> str:
    """The self-contained worker program for ``python -u -``: a preamble
    that sets the environment, ``sys.path`` and ``sys.argv``, then
    worker.py's own source, run as ``__main__``. The authkey rides the
    stdin, never a command line."""
    driver_host, port, rank, world = connect
    wenv = dict(env)
    wenv["RLT_WORKER_AUTHKEY"] = authkey_hex
    with open(_WORKER_PATH, "r") as f:
        worker_src = f.read()
    preamble = (
        "import os, sys\n"
        f"os.environ.update({wenv!r})\n"
        f"_pp = {list(pythonpath)!r}\n"
        "if _pp:\n"
        "    os.environ['PYTHONPATH'] = os.pathsep.join(\n"
        "        _pp + ([os.environ['PYTHONPATH']]\n"
        "               if os.environ.get('PYTHONPATH') else []))\n"
        "    sys.path[:0] = _pp\n"
        f"sys.argv = ['worker.py', {driver_host!r}, {str(port)!r}, "
        f"{str(rank)!r}, {str(world)!r}]\n"
    )
    return preamble + worker_src


class SSHTransport(Transport):
    """Start workers on remote hosts over ssh.

    ssh            argv prefix, run as ``<ssh...> <host> -- <python> -u -``
                   (default: plain ssh in BatchMode, no password prompt).
    remote_python  the interpreter on the remote host.
    pythonpath     remote directories put first on the worker's
                   ``sys.path``/``PYTHONPATH`` (where the package and the
                   jobs' modules live, if not installed).
    env            environment for every worker, under the group's own.
    host_env       per-host overrides keyed by the ``hosts=`` entry, over
                   ``env``. The multi-NIC escape hatch:
                   ``host_env={ssh_addr: {"RLT_NODE_IP": fabric_addr}}``
                   pins the address that host's worker advertises (and,
                   for worker 0, the rendezvous it serves) to the data
                   network, whatever address ssh dials.

    One worker a host::

        transport = SSHTransport(remote_python="python3",
                                 pythonpath=["/srv/project"])
        fit_distributed(..., num_processes=2, hosts=[ip0, ip1],
                        transport=transport)
    """

    is_remote = True

    def __init__(self, ssh: Sequence[str] = ("ssh", "-o", "BatchMode=yes"),
                 remote_python: str = "python3",
                 pythonpath: Sequence[str] = (),
                 env: Optional[Dict[str, str]] = None,
                 host_env: Optional[Dict[str, Dict[str, str]]] = None):
        self.ssh = list(ssh)
        self.remote_python = remote_python
        self.pythonpath = list(pythonpath)
        self.env = dict(env or {})
        self.host_env = {k: dict(v) for k, v in (host_env or {}).items()}

    def _command(self, host: Optional[str]) -> list:
        if not host:
            raise ValueError("SSHTransport needs a host per worker "
                             "(pass hosts=[...] to WorkerGroup)")
        return self.ssh + [host, "--", self.remote_python, "-u", "-"]

    def _popen_env(self) -> Optional[dict]:
        return None  # the ssh client runs with the driver's environment

    def spawn(self, *, host, connect, env, authkey_hex, log_path):
        source = _bootstrap_source(
            connect, {**self.env, **env, **self.host_env.get(host or "", {})},
            authkey_hex, self.pythonpath)
        with open(log_path, "w") as logf:
            proc = subprocess.Popen(
                self._command(host), stdin=subprocess.PIPE, stdout=logf,
                stderr=subprocess.STDOUT, env=self._popen_env())

        # the bootstrap goes in on a helper thread: an ssh that never
        # drains its stdin must fail the start at the group's
        # start_timeout, not block the driver inside write()
        def _feed(stdin, data):
            try:
                stdin.write(data)
                stdin.close()
            except (BrokenPipeError, OSError):
                pass  # a dead ssh: poll() and the log tail report it

        threading.Thread(target=_feed, args=(proc.stdin, source.encode()),
                         daemon=True).start()
        return proc


class LoopbackTransport(SSHTransport):
    """The SSH bootstrap without ssh: ``python -u -`` locally, with the
    environment scrubbed to what a login shell has (the driver's
    environment does not leak in; only the explicit env and the
    bootstrap's preamble do). The cross-host path on one machine."""

    #: remote semantics, but the processes are local: loopback is a valid
    #: driver address here (the group's fail-fast on an unroutable driver
    #: is for workers on other machines)
    allows_loopback = True

    #: what a login shell would have anyway; everything else is dropped
    _KEEP = ("PATH", "HOME", "TMPDIR", "LANG", "LC_ALL", "USER", "SHELL")

    def __init__(self, pythonpath: Sequence[str] = (_REPO_ROOT,), **kw):
        super().__init__(pythonpath=pythonpath, **kw)
        self.spawned: list = []  # (host, rank): introspection

    def _command(self, host):
        return [sys.executable, "-u", "-"]

    def _popen_env(self):
        return {k: os.environ[k] for k in self._KEEP if k in os.environ}

    def spawn(self, *, host, connect, env, authkey_hex, log_path):
        self.spawned.append((host, connect[2]))
        return super().spawn(host=host, connect=connect, env=env,
                             authkey_hex=authkey_hex, log_path=log_path)
