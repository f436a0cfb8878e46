"""The system's retrieval daemon in a process of its own, with a device
trace on demand:

    python -m reid_bench.daemon <cli.extract arguments, e.g. serve --listen unix:PATH ...>

runs ``grl_tpu_torch.cli.extract``'s ``main`` (which sets the precision
policy and serves) in a thread, and reads commands on standard input:

    trace start        start a device trace (torch.profiler, device activity)
    trace stop PATH    stop it and write its timeline to PATH as JSON
                       (``{"start_ns", "end_ns", "events": [[name, start, end], ...]}``)
    peak               the card's peak allocated bytes in this process
    modules            the loaded modules whose top-level name is JAX's or
                       the JAX package's (``run.FORBIDDEN``), as a JSON list

and answers each on standard output (``ok``, the number, or the list). The daemon itself stops
on its protocol's ``shutdown`` op; this process ends when it has.
"""

from __future__ import annotations

import json
import sys
import threading


def main(argv):
    from grl_tpu_torch.cli import extract

    from .run import forbidden_modules
    from .trace import DeviceTrace

    args = extract.build_parser().parse_args(argv)
    served = threading.Thread(target=extract.main, args=(args,), name="serve")
    served.start()
    tracer = None
    for line in sys.stdin:
        words = line.split()
        if words[:2] == ["trace", "start"]:
            tracer = DeviceTrace(args.device)
            tracer.__enter__()
        elif words[:2] == ["trace", "stop"] and tracer is not None:
            tracer.__exit__(None, None, None)
            tl = tracer.timeline
            with open(words[2], "w") as f:
                json.dump({"start_ns": tl.start_ns, "end_ns": tl.end_ns, "events": tl.events}, f)
            tracer = None
        elif words[:1] == ["peak"]:
            import torch

            print(torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0, flush=True)
            continue
        elif words[:1] == ["modules"]:
            print(json.dumps(forbidden_modules()), flush=True)
            continue
        else:
            continue
        print("ok", flush=True)
    served.join()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
