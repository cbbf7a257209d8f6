"""E2E test harness: spawn the real headless app with a temp config root
and drive it over HTTP.

Mirrors the reference's Python harness (reference: e2e/e2e_common.py —
SDRPPTestContext spawns the binary with --root/--http, pre-seeds
config.json with a file source + null audio sink, polls
/status.mainLoopStarted, posts /module/<inst>/command).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from typing import Dict, Optional


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def http_get(base: str, path: str, timeout: float = 5.0) -> Dict:
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return json.loads(r.read().decode())


def http_post(base: str, path: str, obj: Dict, timeout: float = 5.0) -> Dict:
    data = json.dumps(obj).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


class AppContext:
    def __init__(self, root: str, config: Dict, autostart: bool = True):
        self.root = root
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump(config, f)
        self.port = free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        args = [sys.executable, "-m", "sdrplusplusbrown_tpu",
                "--root", root, "--http", str(self.port),
                "--platform", "cpu"]
        if autostart:
            args.append("--autostart")
        env = dict(os.environ)
        self.log_path = os.path.join(root, "app.log")
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(args, stdout=self._log,
                                     stderr=subprocess.STDOUT, env=env,
                                     cwd=os.path.dirname(
                                         os.path.dirname(__file__)))

    def wait_ready(self, timeout: float = 60.0) -> bool:
        t0 = time.time()
        while time.time() - t0 < timeout:
            if self.proc.poll() is not None:
                return False
            try:
                st = http_get(self.base, "/status", timeout=0.5)
                if st.get("mainLoopStarted"):
                    return True
            except Exception:
                pass
            time.sleep(0.2)
        return False

    def module_cmd(self, inst: str, cmd: str, args: str = "",
                   timeout: float = 60.0) -> Dict:
        # rebuild-triggering commands can wait on the module mutex while
        # the pump finishes an XLA compile — allow generous time
        return http_post(self.base,
                         f"/module/{inst.replace(' ', '%20')}/command",
                         {"cmd": cmd, "args": args}, timeout=timeout)

    def get(self, path: str, timeout: float = 5.0) -> Dict:
        return http_get(self.base, path, timeout=timeout)

    def post(self, path: str, obj: Dict, timeout: float = 5.0) -> Dict:
        return http_post(self.base, path, obj, timeout=timeout)

    def pump_step(self, blocks: int, timeout: float = 1800.0) -> Dict:
        """Synchronously process ``blocks`` pipeline blocks (manual pump
        mode).  The generous timeout covers an in-request XLA compile."""
        return http_post(self.base, "/pump/step", {"blocks": blocks},
                         timeout=timeout)

    def close(self):
        try:
            http_get(self.base, "/stop", timeout=2)
        except Exception:
            pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=5)
        self._log.close()

    def log_tail(self, chars: int = 3000) -> str:
        try:
            with open(self.log_path) as f:
                return f.read()[-chars:]
        except OSError:
            return ""
