"""The wait for the scan's product writes (the PNG's encode and write on
the writer pool): the program's sub-span ``write barrier`` of stage
``products`` (pipeline/run.py:process_scan), a scan's mean over the
window; None where the program records no such span."""


def read(run):
    key = "products:write barrier"
    if not any(key in r.stages for r in run.scans if r.ok):
        return None
    return run.stage_ms(key)
