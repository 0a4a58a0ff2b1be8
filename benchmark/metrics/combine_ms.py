"""combine_ms.<kind> (ms): the host combination of an MSM's window sums
(``ops.msm.combine_window_sums``) per request, from the program's
``msm.combine`` span.  A program without that span leaves the combination
outside every span, as the last of a request's host work; there it is read
as the time from the end of the request's last span to the request's end,
the flag read and the sums' copy to the host included."""

import bisect


def read(run):
    s = run.per_request("msm.combine")
    if s is not None:
        return s * 1e3
    ends = sorted(e for _, _, e in run.span_intervals)
    tails = []
    for a, b in run.requests:
        k = bisect.bisect_right(ends, b) - 1
        if k >= 0 and ends[k] >= a:
            tails.append(b - ends[k])
    return 1e3 * sum(tails) / len(tails) if tails else None
