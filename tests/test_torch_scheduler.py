"""The port's request schedulers against the JAX package's: the same
appends, pops, peeks, takes (with a scripted selector), pushbacks and
drains give the same items in the same order under ``FIFOQueue``,
``WeightedFairQueue`` and ``NestedScheduler``; a selector that raises
loses no item.  Over HTTP, a replica built with a ``scheduler_factory``
takes the request's ``"queue"`` field.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from alpa_tpu.serve import scheduler as jsched
from alpa_tpu_torch.model.gpt_model import GPTConfig
from alpa_tpu_torch.serve import RequestBatcher, run_controller
from alpa_tpu_torch.serve import scheduler as tsched

QUEUES = ("default", "paid/alice", "paid/bob", "free/carol", "free/dan")
WEIGHTS = {"paid/alice": 3.0, "paid/bob": 2.0, "free/carol": 0.5}


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Building a torch module draws its default init from the global RNG;
    restore that state so these tests leave other tests' draws alone."""
    with torch.random.fork_rng():
        yield


def _factories(mod):
    return {
        "fifo": mod.FIFOQueue,
        "wfq": lambda: mod.WeightedFairQueue(WEIGHTS, default_weight=1.5),
        "nested": lambda: mod.NestedScheduler(
            outer=mod.WeightedFairQueue({"paid": 4.0, "free": 1.0})),
    }


def _run_script(queue, seed):
    """A seeded script of protocol calls; returns what each call gave."""
    rng = np.random.default_rng(seed)
    log, popped, n = [], [], 0
    for _ in range(300):
        op = rng.choice(["append", "append", "append", "pop", "peek",
                         "take", "pushback", "len"])
        if op == "append":
            queue.append({"queue": str(rng.choice(QUEUES)), "i": n})
            n += 1
        elif op == "pop" and len(queue):
            popped.append(queue.popleft())
            log.append(("pop", popped[-1]["i"]))
        elif op == "peek":
            head = queue.peek()
            log.append(("peek", None if head is None else head["i"]))
        elif op == "take":
            decisions = rng.choice(["take", "skip", "stop"], size=64,
                                   p=[0.45, 0.45, 0.1])
            state = {"k": 0}

            def selector(item, decisions=decisions, state=state):
                state["k"] += 1
                return str(decisions[(item["i"] + state["k"]) % 64])

            log.append(("take", [it["i"] for it in queue.take(selector)]))
        elif op == "pushback" and popped:
            back, popped = popped[-2:], popped[:-2]
            queue.pushback(back)
        log.append(("len", len(queue)))
    log.append(("drain", [it["i"] for it in queue.drain()]))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("policy", ["fifo", "wfq", "nested"])
def test_order_equals_jax(policy, seed):
    want = _run_script(_factories(jsched)[policy](), seed)
    got = _run_script(_factories(tsched)[policy](), seed)
    assert got == want
    assert sum(len(entry[1]) for entry in got if entry[0] == "take") > 0


@pytest.mark.parametrize("policy", ["fifo", "wfq", "nested"])
def test_a_raising_selector_loses_no_item(policy):
    def run(mod):
        queue = _factories(mod)[policy]()
        for i in range(12):
            queue.append({"queue": QUEUES[i % len(QUEUES)], "i": i})
        seen = []

        def selector(item):
            seen.append(item["i"])
            if len(seen) == 4:
                raise RuntimeError("selector fault")
            return "take" if item["i"] % 2 else "skip"

        with pytest.raises(RuntimeError, match="selector fault"):
            queue.take(selector)
        return seen, [it["i"] for it in queue.drain()]

    seen, left = run(tsched)
    assert (seen, left) == run(jsched)
    assert sorted(left) == list(range(12))


def test_batcher_rejects_a_queue_without_the_protocol():
    with pytest.raises(TypeError, match="lacks append"):
        RequestBatcher(None, scheduler=object())


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())["output_ids"][0]


def test_queue_field_rides_the_replica_scheduler():
    made = []

    def factory():
        made.append(tsched.WeightedFairQueue({"paid": 4.0}))
        return made[-1]

    cfg = GPTConfig(hidden_size=32, num_layers=1, num_heads=2, seq_len=32,
                    vocab_size=64)
    server = run_controller(port=0, device="cpu")
    try:
        server.controller.register_model("m", cfg, scheduler_factory=factory)
        body = {"model": "m", "prompt_ids": [1, 2, 3], "max_new_tokens": 2}
        plain = _post(server.port, body)
        assert _post(server.port, {**body, "queue": "paid"}) == plain
        assert len(made) == 1       # the batcher's; the engine is not built
        for bad in (["x"], "q" * 65):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server.port, {**body, "queue": bad})
            assert e.value.code == 400
    finally:
        server.shutdown()
