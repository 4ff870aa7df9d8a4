"""What the CPU tests run: the cells of ``BENCHMARK.json``, and every loop
the drivers have (also those no cell runs yet), over fewer molecules and
smaller batches, at the configurations' own widths."""

import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parents[1]
SMALL = {
    "pretrain": {"molecules": 256, "batch_size": 32},
    "finetune": {"molecules": 300, "batch_size": 32, "split": [160, 70, 70],
                 "trace_epochs": 1},
}
CELLS = tuple(w["name"] for w in json.loads(
    (HERE.parent / "BENCHMARK.json").read_text())["workloads"])
# (configuration, traffic): the two cells' loops, the GIN stream and
# fine-tuning
LOOPS = (("scgib-gin64", "pcqm-stream"), ("scgib-gt64", "pcqm-stream"),
         ("scgib-gin64", "pcqm-resident"), ("scgib-gin64", "bace-finetune"))


def small(traffic: dict) -> dict:
    return {**traffic, **SMALL[traffic["loop"]]}


def load(config: str, traffic: str):
    """A configuration and a traffic mix by name, the traffic made
    small."""
    return (json.loads((HERE / "configs" / f"{config}.json").read_text()),
            small(json.loads((HERE / "traffic" / f"{traffic}.json")
                             .read_text())))
