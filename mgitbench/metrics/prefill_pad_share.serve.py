"""Share of the engine's prefill slots (batch x width of each request,
``engine.prefill_slots``) that held padding rather than a real prompt
token (``engine.prompt_tokens``), as the program counted them in the
traced window."""


def program_counts():
    from repro_torch import obs
    counts = getattr(obs, "counts", None)
    return counts() if counts is not None else {}


def read(run):
    got = program_counts()
    slots = got.get("engine.prefill_slots", 0)
    if slots <= 0:
        return None
    return 100.0 * (1.0 - got.get("engine.prompt_tokens", 0) / slots)
