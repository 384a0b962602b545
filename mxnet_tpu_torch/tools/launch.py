#!/usr/bin/env python
"""Distributed job launcher of the port, the counterpart of the JAX
package's tools/launch.py (reference tools/launch.py + dmlc_tracker).

Starts N workers and S parameter servers (`python -m
mxnet_tpu_torch.kvstore_server`, which imports neither JAX nor the JAX
package) with the DMLC_* env contract, and runs the user command in each
worker. The options and the behaviour are the JAX launcher's:

  * --launcher local: every process on this machine; ssh: one process
    group per host of a hostfile.
  * -s 0: no servers; the workers' `dist.initialize()` reads rank,
    size and the coordinator's address (DMLC_WORKER_ID,
    DMLC_NUM_WORKER, DMLC_PS_ROOT_URI, MXNET_TPU_DIST_PORT), and rank 0
    hosts the coordinator.
  * a worker exiting non-zero SIGTERMs every sibling's process group
    and the launcher exits with its code, naming the rank; SIGTERM and
    SIGINT go on to every child group.
  * --elastic: a worker lost to a signal, or exiting PREEMPTED_EXIT (a
    survivor that committed its final checkpoint), triggers a relaunch
    at the same world size, or smaller by the lost workers with
    --elastic-shrink, up to --max-restarts times
    (MXNET_TPU_DIST_RESTART_COUNT counts them).
  * a token (DMLC_PS_TOKEN) minted for each job, unless one is set.
  * --ranks-per-worker R (local, not elastic): each worker is R
    processes, the ranks of a data mesh of its own over a process group
    of its own (parallel/worker_group.py); the servers and the dist
    runtime see -n workers. A worker's code is its first failing rank's.

The package directory's parent goes first on the children's PYTHONPATH,
so that `-m mxnet_tpu_torch.kvstore_server` resolves from any working
directory.

Usage:
  python -m mxnet_tpu_torch.tools.launch -n 2 -s 1 --launcher local \
      python train_script.py --kv-store dist_sync
"""
import argparse
import os
import secrets
import signal
import socket
import subprocess
import sys
import time

# keep in sync with mxnet_tpu_torch.dist.PREEMPTED_EXIT (the launcher
# does not import the framework: it is a small supervisor, and the
# workers' imports are what it restarts)
PREEMPTED_EXIT = 75

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port_range(n):
    """Find a base port with n consecutive free ports (server sid binds
    base+sid, kvstore_server.py; the dist coordinator binds base+S)."""
    for _ in range(64):
        probe = socket.socket()
        probe.bind(('', 0))
        base = probe.getsockname()[1]
        probe.close()
        socks = []
        try:
            for i in range(max(n, 1)):
                s = socket.socket()
                s.bind(('', base + i))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError('could not find %d consecutive free ports' % n)


def _signal_group(p, sig):
    """Signal a child's whole process group (children start in their
    own sessions so a worker's subprocess tree dies with it)."""
    try:
        os.killpg(p.pid, sig)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            p.send_signal(sig)
        except (ProcessLookupError, OSError):
            pass


def _stop_procs(procs, grace=10.0):
    """SIGTERM (elastic final-checkpoint path) then SIGKILL leftovers."""
    for p in procs:
        if p.poll() is None:
            _signal_group(p, signal.SIGTERM)
    deadline = time.monotonic() + grace
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    for p in procs:
        if p.poll() is None:
            _signal_group(p, signal.SIGKILL)
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass


def _normalize_rc(rc):
    """Shell convention for the launcher's own exit code: signal
    deaths map to 128+signum (the child's code otherwise)."""
    return rc if rc >= 0 else 128 - rc


def _launch_round(args, command, world, restarts):
    """One generation of the job: spawn servers + workers, supervise,
    return {rank: returncode} for the workers.  Fail-fast semantics
    (non-elastic): the first non-zero worker exit SIGTERMs every
    sibling group and raises SystemExit with that worker's code and
    rank.  Elastic: abnormal exits are collected; surviving workers
    get --elastic-grace seconds to detect the death by heartbeat loss
    and commit their final checkpoints before being SIGTERMed."""
    host = '127.0.0.1'
    # past the servers: base+S for the dist coordinator (rank 0 binds
    # it), base+S+1 kept free as the JAX launcher keeps it,
    # then ONE MORE PER RANK for the ring topology's peer-to-peer
    # listeners (rank r binds MXNET_TPU_DIST_RING_PORT + r under
    # MXNET_TPU_DIST_TOPOLOGY=ring) — all probed free up front instead
    # of failing mid-first-step on a busy port
    rpw = args.ranks_per_worker
    # and, for workers of several ranks, one rendezvous port a worker
    group_base = args.num_servers + 2 + world
    port = args.port or _free_port_range(
        group_base + (world if rpw > 1 else 0))
    base_env = dict(os.environ)
    base_env.update({
        'DMLC_PS_ROOT_URI': host,
        'DMLC_PS_ROOT_PORT': str(port),
        'DMLC_NUM_WORKER': str(world),
        'DMLC_NUM_SERVER': str(args.num_servers),
        'MXNET_TPU_DIST_PORT': str(port + args.num_servers),
        'MXNET_TPU_DIST_RING_PORT': str(port + args.num_servers + 2),
        'MXNET_TPU_DIST_RESTART_COUNT': str(restarts),
        # a per-job secret even on loopback: frames are then
        # unforgeable by other local users, and the set_optimizer
        # channel (which requires a token) works out of the box
        'DMLC_PS_TOKEN': os.environ.get('DMLC_PS_TOKEN')
                         or secrets.token_hex(16),
        'PYTHONPATH': os.pathsep.join(
            [_ROOT] + [p for p in os.environ.get('PYTHONPATH', '').split(
                os.pathsep) if p]),
    })
    servers = []
    workers = []
    got_signal = []

    def _forward(signum, frame):
        # forward to every child group so elastic's final-checkpoint
        # path runs under the launcher too; a second signal escalates
        if got_signal:
            for p in servers + workers:
                _signal_group(p, signal.SIGKILL)
        got_signal.append(signum)
        for p in servers + workers:
            if p.poll() is None:
                _signal_group(p, signal.SIGTERM)

    old_handlers = {s: signal.signal(s, _forward)
                    for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        for sid in range(args.num_servers):
            env = dict(base_env)
            env.update({'DMLC_ROLE': 'server',
                        'DMLC_SERVER_ID': str(sid)})
            servers.append(subprocess.Popen(
                [sys.executable, '-W', 'ignore::RuntimeWarning:runpy', '-m',
                 'mxnet_tpu_torch.kvstore_server'],
                env=env, start_new_session=True))
        for wid in range(world):
            for r in range(rpw):
                env = dict(base_env)
                env.update({'DMLC_ROLE': 'worker',
                            'DMLC_WORKER_ID': str(wid)})
                if rpw > 1:
                    env.update(_group_env(wid, r, rpw, world, host,
                                          port + group_base + wid))
                workers.append(subprocess.Popen(command, env=env,
                                                start_new_session=True))
        # a worker's code: the first non-zero code of its ranks
        rcs = {}
        proc_rcs = {}
        launcher_killed = set()
        grace_deadline = None
        while len(proc_rcs) < len(workers):
            for j, p in enumerate(workers):
                if j in proc_rcs:
                    continue
                rc = p.poll()
                if rc is None:
                    continue
                proc_rcs[j] = rc
                wid = j // rpw
                if rcs.get(wid, 0) == 0:
                    rcs[wid] = rc
                if rc != 0 and not got_signal:
                    if not args.elastic:
                        # fail-fast: kill the sibling process groups
                        # and exit with this worker's code + rank —
                        # a crashed worker must not leave siblings
                        # blocked in a barrier forever
                        _stop_procs([q for i, q in enumerate(workers)
                                     if i != j] + servers,
                                    grace=args.grace)
                        print('launcher: worker %d exited with %s — '
                              'killed %d sibling(s), aborting'
                              % (wid, 'signal %d' % -rc if rc < 0
                                 else 'code %d' % rc,
                                 len(workers) - 1), file=sys.stderr)
                        raise SystemExit(_normalize_rc(rc))
                    if grace_deadline is None:
                        # give survivors time to detect the death by
                        # heartbeat loss and commit final checkpoints
                        grace_deadline = time.monotonic() + \
                            args.elastic_grace
            if grace_deadline is not None and \
                    time.monotonic() >= grace_deadline:
                # workers the LAUNCHER signals past the grace window
                # are healthy survivors, not lost machines — record
                # them so --elastic-shrink never shrinks the world on
                # a launcher-inflicted SIGTERM/SIGKILL exit code
                launcher_killed.update(j for j in range(world)
                                       if j not in rcs)
                _stop_procs([q for j, q in enumerate(workers)
                             if j not in proc_rcs], grace=args.grace)
                grace_deadline = None
            time.sleep(0.05)
        return rcs, launcher_killed, bool(got_signal)
    finally:
        _stop_procs(workers + servers, grace=args.grace)
        for s, h in old_handlers.items():
            signal.signal(s, h)


def _group_env(wid, rank, size, world, host, port):
    """The variables of rank `rank` of worker `wid`'s `size` ranks: its
    place in the worker (parallel/worker_group.py) and torchrun's, for
    the worker's own process group. The card of a rank is LOCAL_RANK
    modulo the host's cards."""
    return {
        'MXNET_TPU_WORKER_RANKS': str(size),
        'MXNET_TPU_WORKER_RANK': str(rank),
        'RANK': str(rank), 'WORLD_SIZE': str(size),
        'LOCAL_RANK': str(wid * size + rank),
        'LOCAL_WORLD_SIZE': str(world * size),
        'MASTER_ADDR': host, 'MASTER_PORT': str(port),
        'GLOO_SOCKET_IFNAME': os.environ.get('GLOO_SOCKET_IFNAME', 'lo'),
    }


def launch_local(args, command):
    """Local launcher: every process on this machine.  With --elastic,
    supervises coordinated restarts (module docstring)."""
    restarts = 0
    world = args.num_workers
    while True:
        rcs, launcher_killed, signaled = _launch_round(
            args, command, world, restarts)
        bad = {r: rc for r, rc in rcs.items() if rc != 0}
        if not bad:
            return 0
        first = sorted(bad)[0]
        if signaled or not args.elastic or restarts >= args.max_restarts:
            desc = ', '.join(
                'worker %d: %s' % (r, 'signal %d' % -rc if rc < 0
                                   else 'code %d' % rc)
                for r, rc in sorted(bad.items()))
            print('launcher: job failed (%s)%s' % (
                desc, '' if not args.elastic or signaled else
                ' after %d restart(s)' % restarts), file=sys.stderr)
            return _normalize_rc(bad[first])
        lost = sorted(r for r, rc in bad.items()
                      if rc < 0 and r not in launcher_killed)
        if args.elastic_shrink and lost:
            world = max(args.min_workers, world - len(lost))
        restarts += 1
        print('launcher: elastic restart %d/%d — %s; relaunching %d '
              'worker(s)' % (
                  restarts, args.max_restarts,
                  ', '.join('worker %d %s' % (
                      r, 'lost to signal %d' % -rc if rc < 0 else
                      'preempted' if rc == PREEMPTED_EXIT else
                      'exited %d' % rc) for r, rc in sorted(bad.items())),
                  world), file=sys.stderr)


def launch_ssh(args, command):
    """One worker per host in --hostfile; servers on the first
    args.num_servers hosts (reference ssh launcher)."""
    with open(args.hostfile) as f:
        hosts = [h.strip() for h in f if h.strip()]
    if len(hosts) < args.num_workers:
        raise SystemExit('hostfile has %d hosts < %d workers'
                         % (len(hosts), args.num_workers))
    import shlex
    root = hosts[0]
    port = args.port or 9091
    # multi-host PS servers refuse to start without a shared secret
    # (kvstore_server._check_bind_policy); mint one for the job unless
    # the operator provided their own.  The token is shipped over ssh
    # stdin (read into the remote environment), never on the remote
    # argv, so it does not show up in `ps` on the hosts.
    token = os.environ.get('DMLC_PS_TOKEN') or secrets.token_hex(16)
    base = ('DMLC_PS_ROOT_URI=%s DMLC_PS_ROOT_PORT=%d DMLC_NUM_WORKER=%d '
            'DMLC_NUM_SERVER=%d'
            % (root, port, args.num_workers, args.num_servers))

    def spawn(host, cmd):
        wrapped = ('IFS= read -r DMLC_PS_TOKEN; export DMLC_PS_TOKEN; '
                   + cmd)
        proc = subprocess.Popen(['ssh', host, wrapped],
                                stdin=subprocess.PIPE, text=True)
        proc.stdin.write(token + '\n')
        proc.stdin.close()
        return proc

    procs = []
    try:
        for sid in range(args.num_servers):
            cmd = '%s DMLC_ROLE=server DMLC_SERVER_ID=%d python3 -m ' \
                'mxnet_tpu_torch.kvstore_server' % (base, sid)
            procs.append(spawn(hosts[sid % len(hosts)], cmd))
        for wid in range(args.num_workers):
            cmd = '%s DMLC_ROLE=worker DMLC_WORKER_ID=%d %s' % (
                base, wid, ' '.join(shlex.quote(c) for c in command))
            procs.append(spawn(hosts[wid], cmd))
        rc = 0
        for p in procs[args.num_servers:]:
            rc = p.wait() or rc
        return rc
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


def main():
    parser = argparse.ArgumentParser(
        description='Launch a distributed job (reference tools/launch.py)')
    parser.add_argument('-n', '--num-workers', type=int, required=True)
    parser.add_argument('-s', '--num-servers', type=int, default=0)
    parser.add_argument('--launcher', default='local',
                        choices=['local', 'ssh'])
    parser.add_argument('--ranks-per-worker', type=int, default=1,
                        help='processes of each worker: its ranks, one '
                        'data mesh of their own, one worker to the '
                        'servers and the dist runtime (local launcher; '
                        'default 1)')
    parser.add_argument('-H', '--hostfile', default=None)
    parser.add_argument('--port', type=int, default=None)
    parser.add_argument('--elastic', action='store_true',
                        help='supervise coordinated restarts: relaunch '
                        'when a worker is lost to a signal or exits '
                        'PREEMPTED_EXIT (%d); workers resume from '
                        'their elastic checkpoints' % PREEMPTED_EXIT)
    parser.add_argument('--max-restarts', type=int, default=3,
                        help='elastic restart budget (default 3)')
    parser.add_argument('--elastic-shrink', action='store_true',
                        help='relaunch at a world size reduced by the '
                        'workers lost to signals (machine deaths); '
                        'default relaunches at equal size')
    parser.add_argument('--min-workers', type=int, default=1,
                        help='floor for --elastic-shrink (default 1)')
    parser.add_argument('--elastic-grace', type=float, default=60.0,
                        help='seconds survivors get to detect a death '
                        'by heartbeat loss and commit final elastic '
                        'checkpoints before being SIGTERMed '
                        '(default 60)')
    parser.add_argument('--grace', type=float, default=10.0,
                        help='SIGTERM-to-SIGKILL teardown grace '
                        '(default 10)')
    parser.add_argument('command', nargs=argparse.REMAINDER)
    args = parser.parse_args()
    if args.command and args.command[0] == '--':
        args.command = args.command[1:]
    if not args.command:
        raise SystemExit('no command given')
    if args.ranks_per_worker > 1 and (args.launcher != 'local' or
                                      args.elastic):
        raise SystemExit('--ranks-per-worker takes the local launcher '
                         'without --elastic')
    if args.launcher == 'local':
        sys.exit(launch_local(args, args.command))
    sys.exit(launch_ssh(args, args.command))


if __name__ == '__main__':
    main()
