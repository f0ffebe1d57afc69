"""Analysis tools of the port.  So far the fault injectors of the serving
layer (:mod:`repro_torch.analysis.faults`); the reference's popcheck lint
rules come with ROADMAP open items §1, item 15."""
