"""The load generator: closed-loop HTTP clients in a process of their own.

`run.py` starts this module's `serve_load` in one spawned child process, so
that the clients do not share the server's interpreter lock, as real
clients on other machines would not.  Standard library only: the child
imports neither torch nor the program.

Each client keeps one HTTP/1.1 connection and sends its next request when
the previous answer's last byte has arrived, after `think_ms`.  Its
requests come from its own seeded stream of decks: a deck holds every
request kind of the mix equally often, and every form (native JSON or SQL)
of a kind equally often, shuffled anew from the seed for each deck.  So
every seed sends the same work, in another order.  A request is timed on
the client's side, from the send to the last byte of the answer."""

from __future__ import annotations

import hashlib
import http.client
import random
import threading
import time

PATHS = {"native": "/druid/v2", "sql": "/druid/v2/sql"}
TIMEOUT_S = 300.0


def deck(kinds):
    """One deck: each kind `n` times, its forms in turn, where `n` is the
    most forms a kind has."""
    n = max(len(k["forms"]) for k in kinds)
    return [(i, k["forms"][j % len(k["forms"])]) for i, k in enumerate(kinds) for j in range(n)]


def client_stream(seed: int, client: int, kinds):
    """Client `client`'s requests: an endless sequence of (kind index, form),
    one shuffled deck after another."""
    rng = random.Random(seed * 1_000_003 + client)
    cards = deck(kinds)
    while True:
        rng.shuffle(cards)
        yield from cards


def _client(port, seed, client, kinds, think_s, start, stop_at, out, bodies, lock):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    records = []
    try:
        start.wait()
        for k, form in client_stream(seed, client, kinds):
            t_send = time.perf_counter()
            if t_send >= stop_at[0]:
                break
            payload = kinds[k]["bodies"][form]
            try:
                conn.request("POST", PATHS[form], payload, {"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                status, qid = resp.status, resp.getheader("X-Druid-Query-Id") or ""
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
                data, status, qid = repr(e).encode(), 0, ""
            t_end = time.perf_counter()
            digest = hashlib.sha1(data).hexdigest()
            with lock:
                bodies.setdefault((k, form, digest), data)
            records.append((client, k, form, t_send, t_end, status, qid, digest))
            if think_s > 0:
                time.sleep(think_s)
    finally:
        conn.close()
        out[client] = records


def closed_loop(port, seed, kinds, clients, think_ms, seconds):
    """Run `clients` closed-loop clients for `seconds`; every request sent
    before the close is awaited.  Returns (start time, records, bodies):
    records are (client, kind, form, t_send, t_end, status, query id,
    body digest), and bodies each distinct answer of a (kind, form) by
    digest."""
    start = threading.Event()
    stop_at = [float("inf")]
    out, bodies, lock = {}, {}, threading.Lock()
    threads = [threading.Thread(target=_client, args=(port, seed, c, kinds, think_ms / 1e3,
                                                      start, stop_at, out, bodies, lock))
               for c in range(clients)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    stop_at[0] = t0 + seconds
    start.set()
    for t in threads:
        t.join()
    records = [r for c in range(clients) for r in out.get(c, [])]
    return t0, records, bodies


def serve_load(conn, port, kinds, clients, think_ms):
    """The child's loop: for each ("run", seed, seconds) received on `conn`,
    run the closed loop and send back its result; stop on ("stop",)."""
    while True:
        msg = conn.recv()
        if msg[0] == "stop":
            break
        _, seed, seconds = msg
        conn.send(closed_loop(port, seed, kinds, clients, think_ms, seconds))
    conn.close()
