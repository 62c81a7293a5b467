"""Share of the engine's decode steps that replayed a captured CUDA graph
(``engine.decode_graph_replays``) rather than ran eagerly
(``engine.decode_eager_steps``), as the program counted them in the
traced window."""


def program_counts():
    from repro_torch import obs
    counts = getattr(obs, "counts", None)
    return counts() if counts is not None else {}


def read(run):
    got = program_counts()
    replays = got.get("engine.decode_graph_replays", 0)
    steps = replays + got.get("engine.decode_eager_steps", 0)
    if steps <= 0:
        return None
    return 100.0 * replays / steps
