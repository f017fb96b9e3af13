"""The share of the video mixer's uniform lookups that missed the kept
uniforms and computed them (the program's counters
``video_mixer.uniform_misses`` over ``video_mixer.uniform_lookups``)."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    lookups = rec.counters.get("video_mixer.uniform_lookups", 0) if rec \
        else 0
    if not lookups:
        return None
    return rec.counters.get("video_mixer.uniform_misses", 0) / lookups * 100
