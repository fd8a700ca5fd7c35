"""The feed consumer's own work: stage ``mean/max`` less its sub-spans
``staging wait`` and ``upload wait`` (dispatching the uploads, pass A's
launches, closing the source), a scan's mean over the window; None where
the program records no ``staging wait``."""


def read(run):
    if not any("mean/max:staging wait" in r.stages
               for r in run.scans if r.ok):
        return None
    return (run.stage_ms("mean/max") - run.stage_ms("mean/max:staging wait")
            - run.stage_ms("mean/max:upload wait"))
