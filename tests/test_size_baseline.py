"""Size-baseline pins (VERDICT r4 #6): the per-fixture/per-config .drc
byte sizes recorded in tests/size_baseline.json (and rendered into
SIZES.md's generated table) must stay exact, so compression-ratio
regressions surface the way throughput regressions do. Regenerate
deliberately with
  python -m tpudraco.tools.batch_analyze --size-table --update-baseline .
and justify the change in the commit message."""

import json
import os

import pytest

PIN_PATH = os.path.join(os.path.dirname(__file__), "size_baseline.json")
REF_DATA = "/root/reference/draco-oxide/tests/data"
needs_ref = pytest.mark.skipif(
    not os.path.isdir(REF_DATA), reason="reference fixtures not mounted")


@needs_ref
def test_size_baseline_bytes_pinned():
    from tpudraco.tools.batch_analyze import size_quality_table

    with open(PIN_PATH) as f:
        pinned = json.load(f)
    rows = size_quality_table(with_quality=False)
    got = {f"{r['fixture']}:{r['config']}": r["bytes"]
           for r in rows if "bytes" in r}
    assert set(got) == set(pinned), (
        "fixture/config matrix changed — regenerate the baseline "
        f"(missing: {sorted(set(pinned) - set(got))[:5]}, "
        f"new: {sorted(set(got) - set(pinned))[:5]})")
    diffs = {k: (pinned[k], got[k]) for k in pinned if pinned[k] != got[k]}
    assert not diffs, (
        f"{len(diffs)} size cells changed (pinned, got): "
        f"{dict(list(diffs.items())[:8])} — if intentional, regenerate "
        "the baseline table and justify in the commit")


@needs_ref
def test_size_baseline_markdown_in_sync():
    """SIZES.md's generated block must match the pinned totals (stale
    docs are worse than no docs)."""
    from tpudraco.tools.batch_analyze import SIZE_TABLE_BEGIN

    baseline_md = os.path.join(os.path.dirname(__file__), "..",
                               "SIZES.md")
    with open(baseline_md) as f:
        text = f.read()
    assert SIZE_TABLE_BEGIN in text, "generated size table missing"
    with open(PIN_PATH) as f:
        pinned = json.load(f)
    configs = sorted({k.split(":", 1)[1] for k in pinned})
    totals = {c: sum(v for k, v in pinned.items()
                     if k.split(":", 1)[1] == c) for c in configs}
    total_line = next(ln for ln in text.splitlines()
                      if ln.startswith("| **total bytes** |"))
    for t in totals.values():
        assert str(t) in total_line, (
            f"total {t} not in SIZES.md table — regenerate it")
