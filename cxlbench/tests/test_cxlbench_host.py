"""The run's host record and pinning: core lists read as the machine
writes them, the main and the other Python threads each on a core of
their own with everything else on the rest, and the window's record of
which thread ran where.  Also the one reader of a quantity split by the
metric it moves."""

import os
import threading

import pytest

from cxlbench import host, run


@pytest.mark.parametrize("text,cores", [("0-3", [0, 1, 2, 3]), ("0-1,4,6-7\n", [0, 1, 4, 6, 7]),
                                        ("5", [5])])
def test_core_lists_read_as_the_machine_writes_them(text, cores):
    assert host._cpulist(text) == cores


def test_a_card_the_machine_does_not_describe_keeps_every_allowed_core():
    allowed = sorted(os.sched_getaffinity(0))
    assert host.local_cores("") == allowed
    assert host.local_cores("00000000:FF:1F.7") == allowed
    assert host.local_cores("[N/A]") == allowed


def test_the_main_and_the_engine_thread_get_a_core_each():
    allowed = sorted(os.sched_getaffinity(0))
    if len(allowed) < 3:
        pytest.skip(f"needs 3 cores to pin, this process may use {len(allowed)}")
    before = os.sched_getaffinity(0)
    pin = host.Pinning(allowed[:3])
    stop = threading.Event()
    engine = threading.Thread(target=stop.wait, name="engine")
    try:
        pin.start()
        assert os.sched_getaffinity(0) == {allowed[2]}
        engine.start()
        placed = pin.settle()
        # other tests may have left threads of their own, each pinned too
        assert placed[threading.main_thread().name] == [allowed[0]]
        assert placed["engine"] == [allowed[1]] and "refused" not in placed
        assert os.sched_getaffinity(engine.native_id) == {allowed[1]}
    finally:
        stop.set()
        engine.join()
        for t in threading.enumerate():
            if t.native_id:
                os.sched_setaffinity(t.native_id, before)


def test_the_window_records_the_busy_threads():
    w = host.Window()
    w.open()
    x = 0
    for i in range(3_000_000):
        x += i
    out = w.close()
    assert 0.0 <= out["steal_share"] <= 1.0 and 0.0 <= out["idle_share"] <= 1.0
    assert any(name == threading.main_thread().name for name, _, _ in out["threads"])
    assert host.probe_ms() > 0


@pytest.mark.parametrize("name,reads", [("idle_share.prefill", "trace"),
                                        ("analyzer_ms.pool8", "counters")])
def test_a_split_quantity_has_one_reader(name, reads):
    read = run.metric_reader(name)
    assert read.__code__.co_filename.endswith(f"/metrics/{name.split('.')[0]}.py")
    if reads == "trace":
        assert read({"trace": None, "window_s": 1.0}) is None
    else:
        assert read({"counters": {"units": 4, "analyzer_s": 0.2}}) == pytest.approx(50.0)
        assert read({"counters": {"units": 4}}) is None
