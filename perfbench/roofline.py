"""A kernel's share of its roofline over a traced slice: the least time
the card could take for the launches seen (the larger of bytes over the
memory bandwidth and operations over the bf16 peak, per launch site, from
the family's counts at the slice's buckets), over their measured time."""

from __future__ import annotations


def share(run, kernel: str, match, launches_per_call: int):
    """Percent of the roofline for ``kernel`` (a key of the family's
    ``kernel_sites``), whose launches ``match`` accepts; each call makes
    ``launches_per_call`` launches that ``counts`` accepts."""
    t, spans = run.trace_data, run.trace_spans
    if t is None or not spans:
        return None
    seconds, _ = t.kernel_s(match)
    _, calls = t.kernel_s(lambda n: match(n) and counts_call(kernel, n))
    if not calls or not seconds:
        return None
    bw, peak = run.peak("hbm_bytes_per_s"), run.peak("bf16_flops")
    per_forward = []
    for batch in spans:
        sites = run.family.kernel_sites(run.cfg, batch).get(kernel, [])
        if not sites:
            return None
        per_forward.append((sum(max(b / bw, o / peak) for b, o in sites), len(sites)))
    bound = sum(b for b, _ in per_forward) / len(per_forward)
    n_sites = per_forward[0][1]
    forwards = calls / launches_per_call / n_sites
    return 100.0 * forwards * bound / seconds


def counts_call(kernel: str, name: str) -> bool:
    """The launch that counts calls: K3's conv passes (two per call)."""
    return "conv3x3_tc_kernel" in name if kernel == "conv_gn_silu" else True
