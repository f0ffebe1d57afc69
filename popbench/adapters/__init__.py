"""The system under test, per domain: how a round's fleet becomes the
program's instance, how a session is opened with the configuration's
settings, and what of a step's result the reference judges.  These are
the only modules of the benchmark that import the program."""
