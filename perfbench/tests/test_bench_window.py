"""The window's rule (whole cycles; a cycle starts only if the previous
one's time says it ends in time), the traffic's determinism and sample,
and the trace's reduction, on made-up inputs."""

import torch

from pbench import traffic
from pbench.runner import whole_cycles
from pbench.trace import Ev, reduce_events


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def serve_with(clock, times):
    def serve(i):
        clock.t += times[i] if i < len(times) else times[-1]
        return i
    return serve


def test_whole_cycles_stop_before_a_cycle_that_would_overrun():
    clock = Clock()
    records, end = whole_cycles(serve_with(clock, [1.0]), 2, 5.5, 0.0, clock)
    # cycles end at 2 and 4; a third would end at 6 > 5.5
    assert records == [0, 1, 2, 3] and end == 4.0


def test_a_zero_window_serves_one_whole_cycle():
    clock = Clock()
    records, _ = whole_cycles(serve_with(clock, [1.0]), 4, 0.0, 0.0, clock)
    assert records == [0, 1, 2, 3]


def test_the_previous_cycle_predicts_the_next():
    clock = Clock()
    # a slow first cycle (3 s) then fast ones (1 s): 3, 4, 5, 6 <= 6.5
    records, end = whole_cycles(serve_with(clock, [3.0, 1.0]), 1, 6.5, 0.0, clock)
    assert records == [0, 1, 2, 3] and end == 6.0


def test_prompts_are_drawn_from_the_seed_in_order():
    mix = traffic.Mix(batch=2, prompt_lengths=(3, 5), new_tokens=2, check_batches=2)
    a = traffic.Prompts(mix, 100, 2**33 + 1, "cpu")
    b = traffic.Prompts(mix, 100, 2**33 + 1, "cpu")
    c = traffic.Prompts(mix, 100, 2**33 + 2, "cpu")
    assert [tuple(a[i].shape) for i in range(4)] == [(2, 3), (2, 5), (2, 3), (2, 5)]
    assert torch.equal(a[3], b[3]) and not torch.equal(a[3], c[3])


def test_the_sample_holds_the_longest_and_one_of_each_length():
    mix = traffic.Mix(batch=8, prompt_lengths=(1024, 2048, 3072, 4092), new_tokens=4,
                      check_batches=4)
    for seed in (0, 7, 2**31 + 5):
        picked = traffic.check_sample(mix, 40, seed)
        assert sorted(mix.length(i) for i in picked) == [1024, 2048, 3072, 4092]
    one = traffic.Mix(batch=64, prompt_lengths=(512,), new_tokens=32, check_batches=1)
    assert len(traffic.check_sample(one, 3, 11)) == 1
    assert traffic.check_sample(one, 3, 11) == traffic.check_sample(one, 3, 11)


def test_trace_reduction():
    h = lambda n, a, b: Ev("perfbench." + n, False, a, b)
    events = [
        h("window", 0, 100), h("generate", 0, 100), h("prefill", 5, 40),
        h("decode_step", 50, 60),
        Ev("cudaLaunchKernel", False, 6, 7, corr=11),
        Ev("cudaLaunchKernel", False, 51, 52, corr=12),
        Ev("cudaLaunchKernel", False, 65, 66, corr=13),
        Ev("gemm", True, 10, 30, corr=11), Ev("flash", True, 50, 55, corr=12),
        Ev("gemm", True, 70, 80, corr=13),
    ]
    r = reduce_events(events)
    assert round(r["window_s"] * 1e9) == 100 and round(r["busy_s"] * 1e9) == 35
    assert r["launches_mapped"] == 3
    dev = {k: round(v * 1e9) for k, v in r["range_device_s"].items()}
    assert dev == {"window": 35, "generate": 35, "prefill": 20, "decode_step": 5}
    gaps = {n: round(v * 1e9) for n, v in r["breakdown"]["idle_gaps"]}
    # 0-10 and 30-50 inside the prefill (at their midpoints), 55-70 and
    # 80-100 only inside generate
    assert gaps == {"prefill": 30, "generate": 35}
    name, seconds = r["breakdown"]["device_ops"][0]
    assert name == "gemm" and round(seconds * 1e9) == 30
