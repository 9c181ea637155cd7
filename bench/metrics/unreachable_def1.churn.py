"""Definition-1 unreachable points (live, no in-edge) of the last index
the engine published, counted once the window has closed."""

PROGRAM = True


def read(obs):
    engine = getattr(obs.program, "engine", None)
    if engine is None:
        return None
    from repro_torch.core.reach import count_unreachable
    return float(count_unreachable(engine.snapshot().index)[0])
