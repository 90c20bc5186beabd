"""The one generator of the benchmark's inputs, driven by a traffic file.

A traffic file names a draw for each column of the configuration, by name
(``by_name``) or by kind (``by_kind``):

- ``zipf`` (``exponent`` s, ``first_id``): ranks from the continuous power
  law of exponent s over [1, n + 1), floored, mapped through a permutation
  of the table's ``n`` rows drawn from the seed (one permutation a table,
  so that a history and its target share their hot rows), plus
  ``first_id`` (1 where row 0 is the padding id);
- ``uniform``: ids uniform over the table's rows from ``first_id``, or
  values uniform in [0, 1) for a dense column;
- ``map`` (``map``, ``of``): the ids of column ``of`` through a map drawn
  from the seed (``maps``: one id of table ``to`` for each row of table
  ``from``; row 0 maps to 0);
- ``lognormal`` (``offset``, ``median``, ``sigma``, ``min``, ``max``): a
  length, ``offset`` (default 0) plus a lognormal draw, rounded and
  clipped;
- ``zeros``.

A column with ``length`` is a history: its positions past the length
column's value are the padding id 0.  Lengths and a request's candidate
count are stratified: n draws are the distribution's quantiles at
``(i + 0.5) / n``, in an order drawn from the seed, so that every seed
gives the same multiset of sizes.  Every draw runs on the device, from a
generator seeded by the run's seed and the column's (or table's, or map's)
name.
"""

import math
import zlib

import numpy as np
import torch


def _gen(seed, what, device):
    state = np.random.SeedSequence([int(seed), zlib.crc32(what.encode())])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0] & (2 ** 63 - 1)))
    return g


def zipf_ranks(n_ids, exponent, shape, gen, device):
    """Ranks in [0, n_ids): the power law of ``exponent`` over
    [1, n_ids + 1), floored, less one."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    a = 1.0 - exponent
    top = (n_ids + 1.0) ** a
    x = (1.0 + u * (top - 1.0)) ** (1.0 / a)
    return (x.floor().long() - 1).clamp_(0, n_ids - 1)


def stratified(n, quantile, gen, device):
    """``quantile(q)`` at q = (i + 0.5) / n for i < n, in an order drawn
    from ``gen``."""
    q = (torch.arange(n, device=device, dtype=torch.float64) + 0.5) / n
    return quantile(q)[torch.randperm(n, generator=gen, device=device)]


def lognormal_quantile(median, sigma):
    def f(q):
        z = math.sqrt(2.0) * torch.erfinv(2.0 * q - 1.0)
        return median * torch.exp(sigma * z)
    return f


def loguniform_quantile(lo, hi):
    def f(q):
        return torch.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    return f


class Generator:
    """Draws the columns of ``config`` by the rules of ``traffic`` from
    ``seed`` on ``device``."""

    def __init__(self, traffic, config, seed, device):
        self.traffic, self.seed, self.device = traffic, seed, device
        self.cols = {}
        self.tables = {}
        for c in config["columns"]:
            self.cols[c["name"]] = c
            if c["kind"] in ("sparse", "varlen"):
                self.tables[c.get("table", c["name"])] = c["vocab"]
            if c["kind"] == "varlen":
                self.cols.setdefault(c["length"],
                                     {"kind": "length", "name": c["length"]})
        self._perms = {}
        self._maps = {}

    def rule(self, name):
        rule = self.traffic["by_name"].get(name)
        if rule is None:
            rule = self.traffic["by_kind"].get(self.cols[name]["kind"])
        if rule is None:
            raise ValueError("the traffic has no draw for column %r" % name)
        return rule

    def _perm(self, table, first):
        if table not in self._perms:
            n = self.tables[table] - first
            self._perms[table] = torch.randperm(
                n, generator=_gen(self.seed, "perm:" + table, self.device),
                device=self.device) + first
        return self._perms[table]

    def _map(self, name):
        if name not in self._maps:
            spec = self.traffic["maps"][name]
            first = spec.get("first_id", 0)
            n_from, n_to = self.tables[spec["from"]], self.tables[spec["to"]]
            m = torch.randint(first, n_to, (n_from,), device=self.device,
                              generator=_gen(self.seed, "map:" + name,
                                             self.device))
            m[:first] = 0
            self._maps[name] = m
        return self._maps[name]

    def draw(self, names, n, done=None):
        """``{name: tensor}`` of ``n`` draws of each column of ``names``
        (and of the columns they depend on, which ``done`` may hold
        already): ids int64 ``[n]`` or ``[n, maxlen]``, lengths int64
        ``[n]``, dense values float32 ``[n]`` or ``[n, dim]``."""
        out = dict(done or {})
        for name in names:
            self._draw(name, n, out)
        return out

    def _draw(self, name, n, out):
        if name in out:
            return out[name]
        col, rule = self.cols[name], self.rule(name)
        kind, dist = col["kind"], rule["draw"]
        dev = self.device
        gen = _gen(self.seed, "col:" + name, dev)
        shape = (n,)
        if kind == "varlen":
            shape = (n, col["maxlen"])
        elif kind == "dense" and col["dim"] > 1:
            shape = (n, col["dim"])
        table = col.get("table", name)
        first = rule.get("first_id", 0)
        if dist == "zipf":
            ranks = zipf_ranks(self.tables[table] - first, rule["exponent"],
                               shape, gen, dev)
            v = self._perm(table, first)[ranks]
        elif dist == "uniform" and kind == "dense":
            v = torch.rand(shape, generator=gen, device=dev)
        elif dist == "uniform":
            v = torch.randint(first, self.tables[table], shape, device=dev,
                              generator=gen)
        elif dist == "map":
            v = self._map(rule["map"])[self._draw(rule["of"], n, out)]
        elif dist == "lognormal":
            v = rule.get("offset", 0) + stratified(
                n, lognormal_quantile(rule["median"], rule["sigma"]), gen,
                dev)
            v = v.round().clamp_(rule["min"], rule["max"]).long()
        elif dist == "zeros":
            v = torch.zeros(shape, device=dev,
                            dtype=torch.float32 if kind == "dense"
                            else torch.int64)
        else:
            raise ValueError("unknown draw %r for column %r" % (dist, name))
        if kind == "varlen" and dist != "map":
            length = self._draw(col["length"], n, out)
            pos = torch.arange(col["maxlen"], device=dev)[None, :]
            v = torch.where(pos < length[:, None], v, torch.zeros_like(v))
        out[name] = v
        return v

    def labels(self, n):
        p = self.traffic["label"]["p"]
        u = torch.rand(n, generator=_gen(self.seed, "label", self.device),
                       device=self.device)
        return (u < p).float()

    def candidate_counts(self, n):
        spec = self.traffic["candidates"]
        v = stratified(n, loguniform_quantile(spec["min"], spec["max"]),
                       _gen(self.seed, "candidates", self.device),
                       self.device)
        return v.round().clamp_(spec["min"], spec["max"]).long()


def flat(values, feature_index, n, device):
    """The program's flat ``[n, input_dim]`` float32 input: each column's
    values at its span of ``feature_index`` (the model's public column
    layout)."""
    width = max(e for _, e in feature_index.values())
    X = torch.zeros(n, width, device=device)
    for name, (s, e) in feature_index.items():
        X[:, s:e] = values[name].reshape(n, e - s).float()
    return X


def columns_of(X, feature_index, config):
    """The columns of flat rows ``X`` (:func:`flat`) back as the
    generator gave them: ids and lengths int64, dense values float32."""
    kinds = {c["name"]: c["kind"] for c in config["columns"]}
    out = {}
    for name, (s, e) in feature_index.items():
        v = X[:, s:e]
        if kinds.get(name) != "varlen" and e - s == 1:
            v = v[:, 0]
        out[name] = v if kinds.get(name) == "dense" else v.long()
    return out


def train_data(traffic, config, seed, device):
    """``(columns, labels)`` of a training cell: ``traffic["rows"]`` draws
    of every column and Bernoulli labels."""
    g = Generator(traffic, config, seed, device)
    n = traffic["rows"]
    return g.draw(list(g.cols), n), g.labels(n)


def request_pool(traffic, config, seed, device):
    """``traffic["pool"]`` requests: ``[{column: numpy array}]`` as a
    client sends them (ids int32, values float32), each request's columns
    of ``per_request`` drawn once and repeated on every candidate's row."""
    g = Generator(traffic, config, seed, device)
    pool = traffic["pool"]
    counts = g.candidate_counts(pool)
    per_request = g.draw(traffic["per_request"], pool)
    per_row = [n for n in g.cols if n not in per_request]
    total = int(counts.sum())
    rows = g.draw(per_row, total)
    counts = counts.tolist()
    host = {k: v.cpu().numpy() for k, v in per_request.items()}
    host_rows = {k: v.cpu().numpy() for k, v in rows.items()}
    requests, start = [], 0
    for i, c in enumerate(counts):
        req = {}
        for name in g.cols:
            if name in host:
                a = np.repeat(host[name][i][None], c, axis=0)
            else:
                a = host_rows[name][start:start + c]
            req[name] = a.astype(np.float32 if g.cols[name]["kind"]
                                 == "dense" else np.int32)
        requests.append(req)
        start += c
    return requests
