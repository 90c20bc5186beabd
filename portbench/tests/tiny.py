"""A checkout root holding the benchmark's cells cut to a size the CPU
runs in seconds: the configurations' tables, widths and depths, the
traffic's rows, batches and pool made small, everything else copied."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_FM_VOCABS = [50, 20000, 17000, 30, 7]


def tiny_configs():
    fm = json.loads((REPO / "portbench/configs/deepfm_criteo_kaggle.json")
                    .read_text())
    fm["columns"] = ([{"kind": "sparse", "name": "C%d" % (i + 1), "vocab": v,
                       "dim": 4} for i, v in enumerate(TINY_FM_VOCABS)]
                     + [{"kind": "dense", "name": "I%d" % (i + 1), "dim": 1}
                        for i in range(3)])
    fm.update(embedding_dim=4, dnn_hidden_units=[16, 8],
              sparse_table_updates=True)
    dn = json.loads((REPO / "portbench/configs/dien_amazon_books.json")
                    .read_text())
    vocab = {"user": 40, "item_id": 30, "cate_id": 7}
    for c in dn["columns"]:
        c["dim"] = 4
        c["vocab"] = vocab[c.get("table", c["name"])]
        if "maxlen" in c:
            c["maxlen"] = 6
    dn.update(embedding_dim=4, hidden_size=8, maxlen=6,
              dnn_hidden_units=[8, 4], att_hidden_units=[6, 3])
    return {"deepfm_criteo_kaggle": fm, "dien_amazon_books": dn}


def tiny_traffic(name):
    t = json.loads((REPO / "portbench/traffic" / (name + ".json"))
                   .read_text())
    if "rows" in t:
        t.update(rows=96, batch=16, warm_seconds=0.2)
    if "pool" in t:
        t.update(pool=12, batch_size=8, checked_requests=4,
                 candidates={"min": 3, "max": 20}, traced_requests=30)
    if "seq_length" in t["by_name"]:
        t["by_name"]["seq_length"].update(offset=1, median=2, min=1, max=6)
    return t


def make_root(root):
    """Write the tiny checkout under ``root``; returns it."""
    root = Path(root)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for d in ("metrics", "reference"):
        shutil.copytree(REPO / "portbench" / d, root / "portbench" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for d in ("configs", "traffic", "limits"):
        (root / "portbench" / d).mkdir(parents=True)
    for name, cfg in tiny_configs().items():
        (root / "portbench/configs" / (name + ".json")).write_text(
            json.dumps(cfg))
    for w in bench["workloads"]:
        path = root / "portbench/traffic" / (w["traffic"] + ".json")
        path.write_text(json.dumps(tiny_traffic(w["traffic"])))
        shutil.copy(REPO / "portbench/limits" / (w["name"] + ".json"),
                    root / "portbench/limits")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
