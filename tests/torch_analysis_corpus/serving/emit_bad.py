# corpus-rules: metrics_registry
"""Seeded unregistered emission against the twin registry beside it,
plus registered shapes that must not fire: a wildcard family with its
histogram suffix, a plain counter with its value."""


def render(stage, value, occupied):
    lines = [f"caption_latency_{stage}_ms_bucket 1"]
    lines.append(f"caption_requests_total {value}")
    lines.append(f"caption_slots_occupied {occupied}")
    lines.append(f"caption_tokens_emitted_total {value}")  # expect: CST-MET-001
    return "\n".join(lines)
