"""Good twin for the silent-except rule: every handler is typed, records
the fault, or re-raises — nothing is swallowed silently."""


def typed_pass(step):
    # a TYPED exception may be deliberately ignored — the handler states
    # exactly what it tolerates
    try:
        return step()
    except ValueError:
        pass


def broad_recording(step, faults):
    # broad catch is fine when the fault is recorded
    try:
        return step()
    except Exception as e:
        faults.append(f"step-error:{type(e).__name__}")
        return None


def broad_reraise(step):
    try:
        return step()
    except Exception:
        raise
