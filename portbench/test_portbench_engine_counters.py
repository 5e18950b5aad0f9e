"""The readers of the engine's serial host path and launch counters
(``serial_host_us.decode``, ``launch_us.decode``) on hand-built windows:
microseconds per horizon dispatched, nothing where no horizon was, and
nothing from a program that keeps no such counter."""
from __future__ import annotations

import pytest

from harness.spec import load_reader
from harness.window import Window

READERS = [("serial_host_us.decode", "serial_s"),
           ("launch_us.decode", "launch_s")]


def _window(t0: dict, t1: dict) -> Window:
    return Window(40.0, 0.0, 40.0, {}, timing0=t0, timing1=t1)


@pytest.mark.parametrize("name,key", READERS)
def test_reads_microseconds_per_horizon(name, key):
    read = load_reader(name)
    w = _window({key: 1.5, "device_syncs": 10},
                {key: 1.5 + 0.125, "device_syncs": 10 + 50})
    assert read(w) == pytest.approx(1e6 * 0.125 / 50)


@pytest.mark.parametrize("name,key", READERS)
def test_reads_nothing_without_a_horizon(name, key):
    read = load_reader(name)
    assert read(_window({key: 2.0, "device_syncs": 7},
                        {key: 2.0, "device_syncs": 7})) is None


@pytest.mark.parametrize("name,key", READERS)
def test_reads_nothing_without_the_counter(name, key):
    """A program whose ``EngineTiming`` lacks the counter."""
    read = load_reader(name)
    assert read(_window({"device_syncs": 3},
                        {"device_syncs": 9})) is None
