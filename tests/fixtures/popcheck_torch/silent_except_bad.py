"""Known-bad fixture for the silent-except rule: three swallowed faults."""


def bare_handler(step):
    try:
        return step()
    except:                     # noqa: E722  -- finding 1: bare except
        pass


def broad_pass(step):
    try:
        return step()
    except Exception:           # finding 2: broad + pass-only body
        pass


def broad_ellipsis(step):
    try:
        return step()
    except BaseException:       # finding 3: broad + ellipsis body
        ...
