#!/usr/bin/env python3
"""Two threads joining one child process, as the reference fleet does.

``repro.serve.fleet`` joins each worker process from two threads at
drain: the pipe's reader thread (``_on_worker_exit``, ``proc.join``)
and ``drain()`` itself (``proc.join``, ``is_alive``, ``exitcode``).
Both end in ``os.waitpid``: the thread that loses gets ``ECHILD`` and
reads an exit code of ``None`` until the winner has stored it, and the
winner may wait long for the interpreter lock while the loser polls.
This script counts, over many children, how often each side reads
``None`` (the reference's "worker exit code None at drain"):

    python3 tools/join_race.py [--start-method fork|spawn] [--trials N]

``repro_torch.serve.fleet`` gives each worker one reaping thread
instead (``tests/test_torch_fleet.py``).
"""
import argparse
import multiprocessing as mp
import threading


def child() -> None:
    pass


def trial(ctx) -> dict:
    """One child joined by a "reader" and a "drain" thread at once."""
    p = ctx.Process(target=child)
    p.start()
    seen = {}
    go = threading.Barrier(2)

    def reader():
        go.wait()
        p.join(timeout=10.0)
        seen["reader"] = p.exitcode

    def drain():
        go.wait()
        p.join(timeout=5.0)
        seen["alive"] = p.is_alive()
        if seen["alive"]:
            p.terminate()
            p.join(timeout=5.0)
        seen["drain"] = p.exitcode

    threads = [threading.Thread(target=reader), threading.Thread(target=drain)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    return seen


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--start-method", default="spawn",
                    choices=("fork", "spawn"))
    ap.add_argument("--trials", type=int, default=200)
    args = ap.parse_args()
    ctx = mp.get_context(args.start_method)
    counts = {"drain": 0, "reader": 0, "alive": 0}
    for _ in range(args.trials):
        seen = trial(ctx)
        counts["drain"] += seen["drain"] is None
        counts["reader"] += seen["reader"] is None
        counts["alive"] += bool(seen["alive"])
    print(f"{args.trials} children ({args.start_method}): the drain thread "
          f"read exit code None {counts['drain']} times, the reader thread "
          f"{counts['reader']} times; is_alive() was True after a join "
          f"{counts['alive']} times")


if __name__ == "__main__":
    main()
