"""iterations_per_call: the integrator loop's iterations (attempted
batch steps) per traced call, from ``IntegrateResult.iterations``."""


def read(run):
    its = [c['iterations'] for c in run.counters if 'iterations' in c]
    return sum(its) / len(its) if its else None
