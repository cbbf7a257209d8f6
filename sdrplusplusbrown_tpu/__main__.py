"""Headless entry point.

reference: core/src/command_args.cpp:4-40 (--root, --http, --server,
--autostart) and server mode core/src/server.cpp:84.  GUI flags are out
of scope; everything is driven through the HTTP control plane.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None):
    p = argparse.ArgumentParser(prog="sdrplusplusbrown_tpu")
    p.add_argument("--root", default="./sdrpp_tpu_root",
                   help="config root directory")
    p.add_argument("--http", type=int, default=8080,
                   help="HTTP debug/automation server port")
    p.add_argument("--autostart", action="store_true",
                   help="start the DSP immediately")
    p.add_argument("--server", action="store_true",
                   help="run the IQ streaming server (headless TCP)")
    p.add_argument("--port", type=int, default=5259,
                   help="streaming server port (with --server)")
    p.add_argument("--rigctl", type=int, default=0,
                   help="run a hamlib rigctl server on this port")
    p.add_argument("--platform", default=None,
                   help="force a jax platform (cpu/gpu)")
    args = p.parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from .app import SDRApp
    from .server.http_server import HttpDebugServer
    from .utils.flog import flog

    done = threading.Event()
    app = SDRApp(args.root)
    http = HttpDebugServer(app, port=args.http, on_exit=done.set)
    http.start()

    stream_server = None
    if args.server:
        from .server.stream_server import StreamServer
        stream_server = StreamServer(app, port=args.port)
        stream_server.start()

    rigctl_server = None
    if args.rigctl:
        from .server.rigctl import RigctlServer
        rigctl_server = RigctlServer(app, port=args.rigctl)
        rigctl_server.start()

    if args.autostart:
        app.start()

    def _sig(_s, _f):
        done.set()

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    flog.info("ready: http on {}", http.port)
    try:
        done.wait()
    finally:
        if stream_server is not None:
            stream_server.stop()
        if rigctl_server is not None:
            rigctl_server.stop()
        app.shutdown()
        http.stop()
    # skip CPython/XLA teardown: a daemon thread still inside compiled
    # code would otherwise abort the process ("exception not rethrown")
    import os
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
