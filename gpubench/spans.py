"""Spans and captures around the program's entries, from the benchmark's side.

`Spans` replaces module attributes of the program (`"module:attr"`) with
wrappers and puts them back on `restore`.  A wrapper can

- time: record a CUDA event at its entry and at its return (`timed`, the
  traced run's window);
- name: open a `torch.profiler.record_function("gpubench/<name>")` span
  (`named`, the traced run's host stretch);
- capture: keep a reference to the arguments and the result of the calls
  made while capturing is on (the frames and steps the check compares).

The program's code is not touched; it calls the wrapper through the module
attribute it looks up.  An entry that is gone is reported and skipped.
"""

from __future__ import annotations

import functools
import importlib
from collections import defaultdict
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function


class Spans:
    def __init__(self, device: torch.device, timed: bool):
        self.device = device
        self.timed = timed
        self.named = False
        self.capturing = False
        self.events: Dict[str, List] = defaultdict(list)
        self.captured: Dict[str, List] = defaultdict(list)
        self._saved = []

    def wrap(self, target: str, name: Optional[str] = None) -> bool:
        """Wrap `module.path:attr`; False if it is gone."""
        mod_name, attr = target.split(":")
        name = name or attr
        try:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
        except (ImportError, AttributeError):
            return False
        if getattr(fn, "__gpubench__", False):
            return True
        wrapper = self._wrapper(fn, name)
        self._saved.append((mod, attr, fn))
        setattr(mod, attr, wrapper)
        return True

    def _wrapper(self, fn, name: str):
        cuda = self.device.type == "cuda"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if self.named:
                with record_function("gpubench/" + name):
                    out = fn(*args, **kwargs)
            elif self.timed and cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*args, **kwargs)
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                self.events[name].append((e0, e1))
            else:
                out = fn(*args, **kwargs)
            if self.capturing:
                self.captured[name].append((args, kwargs, out))
            return out

        wrapper.__gpubench__ = True
        return wrapper

    def restore(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def mean_ms(self, name: str) -> Optional[float]:
        """Mean CUDA-event ms from the span's entry to its return, over every
        call timed (None where the span never ran)."""
        evs = self.events.get(name)
        if not evs:
            return None
        torch.cuda.synchronize(self.device)
        return sum(a.elapsed_time(b) for a, b in evs) / len(evs)

    def take(self, name: str) -> List:
        """The captured (args, kwargs, result) of `name`, emptied."""
        return self.captured.pop(name, [])
