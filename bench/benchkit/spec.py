"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root names each cell's configuration (whose
``file`` it gives) and traffic mix, and every metric. Everything else is
a file of its own, looked up by that name under ``<root>/bench/`` first
and then beside this package, so a later cell, mix or metric is added by
adding files:

- ``traffic/<mix>.json``: the mix's parameters; its ``driver`` names
  ``drivers/<driver>.py``, the loop that drives the program;
- ``limits/<cell>.json``: the limit of each number compared;
- ``metrics/<metric>.py``: ``read(run)``, the metric's value or None;
- ``reference/<family>.py``: the plain reference a configuration names
  by its ``reference`` key;
- ``families/<family>.py``: the adapter of that same family, through
  which the harness, the drivers and the readers reach everything that
  depends on the model's architecture.

A family adapter is a module that provides:

- ``sizes(name, cfg)``: the family's sizes (an object with at least
  ``vocab``), read from the configuration file's published
  ``config.json`` keys; it raises ``ValueError`` on a file whose block
  the family does not compute exactly;
- ``arch_config(sizes)``: the port's ``ArchConfig`` of those sizes;
- ``make_weights(sizes, seed, device, dtype=torch.bfloat16)``: the
  weights drawn from the seed on the device, as the reference takes
  them; ``port_tree(w, sizes)``: the port's parameter tree over them;
  ``port_leaves(tree, sizes)`` and ``stacked_leaves(w, sizes)``: ``{leaf
  name: tensor}`` of a tree shaped like the port's and of the weights,
  under one set of names;
- ``cache_views(cache, S)``: for each layer of the port's prefill cache,
  ``{name: tensor}`` over the prompt's ``S`` positions, under the names
  that the reference's ``on_layer(i, {name: tensor})`` gives that layer
  (a family may hold different state in different layers: K and V in
  one, a convolution window and a scan state in another);
- ``prefill_flops(sizes, B, S)`` and ``train_step_flops(sizes, B, S)``:
  the model operations of a call, which the MFU readers count;
  ``attention_layers(sizes)`` and ``attention_shape(sizes)`` (heads, KV
  heads, head width): what the flash readers count.

Not there yet, for the first family with layers of more than one kind:
per-kind readers of the program's ``prefill.mixer`` and ``prefill.ffn``
spans (they carry ``kind``; `program_spans` sums every kind), and a
roofline reader for the selective scan's kernel.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # the bench directory


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dirs = [self.root / "bench", HERE]

    def find(self, kind: str, name: str, suffix: str) -> Path:
        for d in self.dirs:
            path = d / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                                f"{[str(d) for d in self.dirs]}")

    def cell(self, name: str) -> dict:
        for cell in self.doc["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> tuple[dict, dict]:
        """(the BENCHMARK.json entry, the file's contents)."""
        for entry in self.doc["configs"]:
            if entry["name"] == name:
                return entry, json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def data(self, kind: str, name: str) -> dict:
        return json.loads(self.find(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        """The module of ``<kind>/<name>.py``, loaded by its path (metric
        names hold dots)."""
        path = self.find(kind, name, ".py")
        key = f"bench_{kind}_{name}".replace(".", "_").replace("-", "_")
        if key in sys.modules:
            return sys.modules[key]
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
        return mod

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``traced`` its
        per-layer ones: those whose ``workloads`` list it; a metric
        without the key goes to every cell, a per-layer one to every cell
        that reports the end-to-end metric it moves."""
        group = self.doc["per_layer" if traced else "end_to_end"]
        out = [m for m in group if cell in m.get("workloads", [cell])]
        if traced:
            moved = {m["name"] for m in self.metrics(cell, traced=False)}
            out = [m for m in out if "workloads" in m or m["moves"] in moved]
        return out
