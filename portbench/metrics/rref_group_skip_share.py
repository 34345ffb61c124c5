"""rref_group_skip_share: the share of the panel groups that the dense
finish's blocked Jordan RREFs reach whose body did not run, dead (the early
exit) or empty (no nonzero in the group's columns): 1 - rref_groups_run /
rref_groups of ``last_phase_stats()``, summed over the window's calls;
nothing where no call reached a group or the program keeps no such
counts."""


def read(record):
    calls = [s for s in record["phase_stats"]
             if "rref_groups" in s and "rref_groups_run" in s]
    groups = sum(s["rref_groups"] for s in calls)
    if not groups:
        return None
    return 1.0 - sum(s["rref_groups_run"] for s in calls) / groups
