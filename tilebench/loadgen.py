"""The load generator: a child process of the run, standard library only.

    python -m tilebench.loadgen PLAN.json PORT T0 OUT_PREFIX [CPUS]

Sends the plan's requests to `http://127.0.0.1:PORT` from monotonic
time `T0` on (the clock is the system's, so parent and child agree), a
closed loop: `clients` callers, each sending the next request of the
shared sequence as soon as its last answer has come, until the window
closes.

Every request sent is awaited until 60 s past the window's close.  It
writes `OUT_PREFIX.json`: one record a request, [sequence index, key
index, sent, done (both monotonic s), HTTP status (0: no answer), body
bytes, body digest], and `OUT_PREFIX.bodies`: each
distinct body of each key once, indexed in the JSON by "key:digest" ->
[offset, length].  It imports nothing but the standard library, and
shares no interpreter lock with the server.  With CPUS (comma-separated
CPU numbers) it runs on those CPUs alone.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import sys
import time

GRACE_S = 60.0


def tile_path(key) -> str:
    z, x, y, s = key
    return f"/{z}/{x}/{y}{'' if s == 1 else f'@{s}x'}.png"


async def fetch(port: int, path: str):
    """One GET on a fresh connection -> (status, body); (0, b"") when the
    connection fails or the answer is malformed."""
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
    except OSError:
        return 0, b""
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: localhost\r\n\r\n".encode())
        await writer.drain()
        data = await reader.read()
    except OSError:
        return 0, b""
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except OSError:
            pass
    head, sep, body = data.partition(b"\r\n\r\n")
    if not sep:
        return 0, b""
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) < 2 or not parts[1].isdigit():
        return 0, b""
    for line in lines[1:]:
        name, _, value = line.partition(":")
        if name.strip().lower() == "content-length" and int(value) != len(body):
            return 0, b""
    return int(parts[1]), body


class Recorder:
    def __init__(self, keys, t0: float):
        self.keys = keys
        self.t0 = t0
        self.records = []
        self.bodies = {}

    async def one(self, port: int, seq_i: int, key_i: int, deadline: float):
        sent = time.monotonic()
        try:
            status, body = await asyncio.wait_for(
                fetch(port, tile_path(self.keys[key_i])), max(deadline - sent, 0.001))
        except asyncio.TimeoutError:
            status, body = 0, b""
        done = time.monotonic()
        digest = hashlib.blake2b(body, digest_size=16).hexdigest()
        if status == 200:
            self.bodies.setdefault(f"{key_i}:{digest}", body)
        self.records.append([seq_i, key_i, sent, done, status, len(body), digest])


async def run_closed(plan, port: int, rec: Recorder, t_end: float) -> None:
    seq = plan["sequence"]
    nxt = [0]

    async def client():
        while True:
            now = time.monotonic()
            if now >= t_end or nxt[0] >= len(seq):
                return
            i = nxt[0]
            nxt[0] += 1
            await rec.one(port, i, seq[i], t_end + GRACE_S)

    await asyncio.gather(*(client() for _ in range(int(plan["clients"]))))


async def main_async(plan, port: int, t0: float) -> Recorder:
    keys = [tuple(k) for k in plan["keys"]]
    rec = Recorder(keys, t0)
    delay = t0 - time.monotonic()
    if delay > 0:
        await asyncio.sleep(delay)
    t_end = t0 + float(plan["seconds"])
    await run_closed(plan, port, rec, t_end)
    return rec


def write(rec: Recorder, prefix: str) -> None:
    index = {}
    with open(prefix + ".bodies", "wb") as f:
        off = 0
        for name, body in rec.bodies.items():
            f.write(body)
            index[name] = [off, len(body)]
            off += len(body)
    with open(prefix + ".json", "w") as f:
        json.dump({"records": rec.records, "bodies": index}, f)


def main(argv) -> int:
    plan_path, port, t0, prefix = argv[:4]
    if len(argv) > 4 and argv[4]:
        os.sched_setaffinity(0, {int(c) for c in argv[4].split(",")})
    with open(plan_path) as f:
        plan = json.load(f)
    rec = asyncio.run(main_async(plan, int(port), float(t0)))
    write(rec, prefix)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
