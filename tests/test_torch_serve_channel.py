"""The port's request channel (`serve/channel.py`) against the JAX
package's (the cases of tests/test_serve_session.py's host-only half),
and their files read across: a command log, its epochs and its cursor
file written by either package's writer are read by the other's reader
record for record, and a request crosses the wire both ways."""
from __future__ import annotations

import json

import numpy as np
import pytest

from ray_lightning_tpu.serve import channel as jch
from ray_lightning_tpu.serve.scheduler import Request as JaxRequest
from ray_lightning_tpu_torch.serve import channel as ch
from ray_lightning_tpu_torch.serve.scheduler import Request


def test_channel_seqs_monotonic_and_acked_batchwise(tmp_path):
    w = ch.ChannelWriter(tmp_path, 0)
    r = ch.ChannelReader(tmp_path, 0, 0)
    assert r.poll() == []          # racing the first send: empty, no error
    s1 = w.send("submit", req={"rid": "a"})
    s2 = w.send("drain")
    assert (s1, s2) == (1, 2) == (s1, w.last_seq)
    cmds = r.poll()
    assert [c["op"] for c in cmds] == ["submit", "drain"]
    assert r.last_seq == 2         # one highest-seq ack per poll batch
    assert r.poll() == []
    with pytest.raises(ValueError, match="unknown channel op"):
        w.send("explode")


def test_channel_torn_tail_reads_as_nothing_new(tmp_path):
    w = ch.ChannelWriter(tmp_path, 0)
    w.send("submit", req={"rid": "a"})
    path = ch.epoch_path(tmp_path, 0, 0)
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"seq": 2, "op": "dr')   # a torn mid-write line
    r = ch.ChannelReader(tmp_path, 0, 0)
    assert [c["seq"] for c in r.poll()] == [1]
    with open(path, "a", encoding="utf-8") as f:
        f.write('ain"}\n')                # the write completes
    assert [c["op"] for c in r.poll()] == ["drain"]


def test_channel_replay_safety_across_respawn(tmp_path):
    w = ch.ChannelWriter(tmp_path, 3)
    for rid in ("a", "b", "c"):
        w.send("submit", req={"rid": rid})
    ch.ChannelReader(tmp_path, 3, 0).poll()
    epoch = w.begin_epoch([{"op": "submit", "req": {"rid": "b"}},
                           {"op": "submit", "req": {"rid": "c"}},
                           {"op": "drain"}])
    assert epoch == w.epoch == 1
    fresh = ch.ChannelReader(tmp_path, 3, 1)
    cmds = fresh.poll()
    assert [c["op"] for c in cmds] == ["submit", "submit", "drain"]
    assert [c["seq"] for c in cmds] == [4, 5, 6]
    w.send("stop", mode="finish")
    assert [c["seq"] for c in fresh.poll()] == [7]
    assert sorted(p.name for p in ch.channel_dir(tmp_path, 3).iterdir()) \
        == ["epoch0.jsonl", "epoch1.jsonl"]


def test_channel_send_at_drops_on_epoch_roll(tmp_path):
    w = ch.ChannelWriter(tmp_path, 0)
    assert w.send_at(0, "submit", req={"rid": "a"}) == 1
    w.begin_epoch([{"op": "submit", "req": {"rid": "a"}}])
    assert w.send_at(0, "submit", req={"rid": "a"}) is None   # stale
    assert w.send_at(1, "drain") == 3                         # current
    cmds = ch.ChannelReader(tmp_path, 0, 1).poll()
    assert [(c["seq"], c["op"]) for c in cmds] \
        == [(2, "submit"), (3, "drain")]


def test_channel_follower_take_upto_buffers_newer(tmp_path):
    w = ch.ChannelWriter(tmp_path, 0)
    for rid in ("a", "b", "c"):
        w.send("submit", req={"rid": rid})
    r = ch.ChannelReader(tmp_path, 0, 0)
    assert [c["seq"] for c in r.take_upto(2)] == [1, 2]
    assert r.last_seq == 2
    assert [c["seq"] for c in r.take_upto(3)] == [3]
    assert r.take_upto(3) == []


def _script(mod, run_dir):
    """The same command history through ``mod``'s writer: two epochs and
    a cursor journal."""
    w = mod.ChannelWriter(run_dir, 1)
    w.send("submit", req={"rid": "a", "prompt": [1, 2]}, preempts=0)
    w.send("pause")
    w.send_at(0, "resume")
    w.begin_epoch([{"op": "submit", "req": {"rid": "a"}},
                   {"op": "drain"}])
    w.send("stop", mode="hard")
    w.close()
    c = mod.CursorWriter(run_dir, 1, 1)
    c.advance(5, True)
    c.advance(6, False)
    c.end()
    c.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_logs_are_one_format_across_packages(tmp_path, writer):
    """Each package writes the same bytes for the same history, and each
    reads the other's files command for command."""
    mods = {"jax": jch, "port": ch}
    other = "port" if writer == "jax" else "jax"
    for name, mod in mods.items():
        _script(mod, tmp_path / name)
    for epoch in (0, 1):
        assert ((tmp_path / "jax" / "channel" / "replica1" /
                 f"epoch{epoch}.jsonl").read_bytes()
                == (tmp_path / "port" / "channel" / "replica1" /
                    f"epoch{epoch}.jsonl").read_bytes())
    src = tmp_path / writer
    for epoch in (0, 1):
        want = mods[writer].ChannelReader(src, 1, epoch).poll()
        got = mods[other].ChannelReader(src, 1, epoch).poll()
        assert got == want and got
    cur = mods[other].CursorReader(src, 1, 1)
    assert [cur.next(), cur.next(), cur.next(), cur.next()] == [
        {"seq": 5, "tick": True}, {"seq": 6, "tick": False},
        {"end": True}, None]


def test_request_wire_roundtrip_both_ways():
    req = Request(rid="r7", prompt=np.arange(5, dtype=np.int32),
                  max_new_tokens=6, temperature=0.6, top_k=3, seed=12,
                  eos_id=2, arrival=1.25, priority="best_effort")
    wire = ch.request_to_wire(req)
    jreq = JaxRequest(rid="r7", prompt=np.arange(5, dtype=np.int32),
                      max_new_tokens=6, temperature=0.6, top_k=3, seed=12,
                      eos_id=2, arrival=1.25, priority="best_effort")
    assert json.dumps(wire) == json.dumps(jch.request_to_wire(jreq))
    back = ch.request_from_wire(jch.request_to_wire(jreq))
    assert isinstance(back, Request)
    jback = jch.request_from_wire(wire)
    for b in (back, jback):
        assert (b.rid, b.max_new_tokens, b.temperature, b.top_k, b.seed,
                b.eos_id, b.arrival, b.priority) == (
            "r7", 6, 0.6, 3, 12, 2, 1.25, "best_effort")
        np.testing.assert_array_equal(np.asarray(b.prompt), np.arange(5))
    # a log written before traffic classes has no priority
    old = {k: v for k, v in wire.items() if k != "priority"}
    assert ch.request_from_wire(old).priority == "standard"
