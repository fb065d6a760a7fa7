"""pushes_per_s: particle pushes a second, nx ny steps of every finished
job over the host-clock time from the first job's start to the last job's
end (each job ends when ``Simulation.run`` has waited for the card).  A
push is one advance, deposit and remesh of one particle."""


from wavebench import stats


def read(run):
    return stats.rate(run.nodes * run.steps * len(run.jobs), run.jobs[0][0],
                      run.jobs[-1][1])
