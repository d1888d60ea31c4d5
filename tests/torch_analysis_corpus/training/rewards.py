# corpus-rules: exceptions
"""Seeded swallow in the reward pool: a scoring failure is dropped on
the floor, the row never comes back, and training waits on it.  The
pool is a concurrency root by file and class, as in the package.
Negative: the handler that routes the exception to the caller."""


class RewardPool:
    def stream(self, jobs):
        for job in jobs:
            try:
                yield job.get()
            except Exception:  # expect: CST-EXC-001
                continue

    def submit(self, job, settle):
        try:
            return job.get()
        except Exception as e:
            settle(e)
