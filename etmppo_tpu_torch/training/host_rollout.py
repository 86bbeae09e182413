"""Rollout for host environments
(counterpart of ``etmppo_tpu/training/host_rollout.py``).

Same contract as ``training/rollout.py``'s ``RolloutFn``: it returns a
``RolloutBatch``, so ``PPOUpdate`` is shared. The envs step on the host (the
process pool of ``envs/host.py`` or the C++ engine of ``envs/native.py``);
the policy, the episodic memory, the K/V caches, the bootstrap value and GAE
stay on the device. The done-resets of step t are folded into the policy
step of t + 1, and ``_finish`` applies the last step's.

Pipelining. With ``pipeline=True`` the workers are split into
``config.host_pipeline_groups`` groups (stepped down until the count
divides ``n_workers`` on one device; only for an env with ``step_group``),
and the groups rotate: group g's policy step for t + 1 is queued right
after its host env step at t, so while the host steps one group's envs the
card runs the other groups' policy steps. JAX gets this overlap from asynchronous dispatch, its
``np.asarray(actions)`` waiting for that group's program alone. Here every
launch goes to one CUDA stream, where ``actions.cpu()`` would wait for all
the work queued before it, the next group's policy step included. So the
sync points are explicit (``_Staging``): each group's actions are copied
into a pinned host buffer with ``non_blocking=True``, an event is recorded
after the copy, and the host waits on that event alone; observations and
dones go to the card from pinned staging buffers of their group, refilled
only once the event recorded after their last copy has passed.

Each group's carries are views of the full-W memory and K/V caches (rows
``[g * Wg, (g + 1) * Wg)``), written in place; the batch's fields are written
in place too, so nothing is concatenated at the end (JAX slices and
concatenates). Random draws come from the one generator, in launch order.

One designed difference: where an episode runs past ``max_episode_steps``
(an env that runs longer than it declares, or a resumed run's freshly
started envs under the saved episode steps), JAX's episode step runs on and
its gathers and scatters clamp or drop the indices past the memory; here the
episode ends for the agent at ``max_episode_steps``, as a truncation (done,
no info, as the pool reports a respawned worker's envs), since such an index
is an error in PyTorch (a device-side assert on the card).

Data parallelism (a ``mesh``, ``parallel/mesh.py``): a rank's env holds its
own workers (``mesh.worker_rows``), and each group's actions are drawn for
the same group of every rank (``Wg * N`` rows) and the rank keeps its rows.
With one group that is the one-device draw, row for row; with several, a
rank's groups cannot be one device's groups (a rank's group g is a block of
its own workers), so the run consumes the same random numbers in another
assignment: it trains the same way but not on one device's trajectories.
``host_pipeline_groups`` must divide a rank's workers there, and a count
that does not raises (on one device it is stepped down, as in the JAX
package).

``obs_uint8`` is refused here: the JAX package's host rollout stores the
float observations unquantized while its update divides every minibatch's
observations by 255, so such a run there trains on ``obs / 255``. The port
does not carry that over.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..models.actor_critic import ActorCriticModel
from ..models.kv_cache import KVCacheStep
from ..ops import distributions
from ..ops.gae import calc_advantages
from ..ops.memory_index import build_memory_indices, build_memory_mask
from ..parallel.mesh import DataMesh
from .rollout import RolloutBatch, bootstrap_value


class HostRolloutState(NamedTuple):
    """Sampler state carried from one update to the next."""
    obs: np.ndarray             # (W, *obs_shape) current obs, on the host
    episode_step: torch.Tensor  # (W,) int64, on the device
    memory: torch.Tensor        # (W, max_ep, blocks, D), on the device


class _Staging:
    """One group's host buffers, pinned on a CUDA device, and the events
    that fence them. On the CPU the copies are synchronous and there is
    nothing to wait for."""

    def __init__(self, n_rows: int, obs_shape, n_branches: int, device):
        self.cuda = device.type == "cuda"
        pinned = dict(pin_memory=self.cuda)
        self.obs = torch.empty((n_rows,) + tuple(obs_shape), **pinned)
        self.dones = torch.empty(n_rows, dtype=torch.bool, **pinned)
        self.actions = torch.empty(n_rows, n_branches, dtype=torch.int32,
                                   **pinned)
        self.stream = torch.cuda.current_stream(device) if self.cuda else None
        self.inputs_copied = torch.cuda.Event() if self.cuda else None
        self.actions_copied = torch.cuda.Event() if self.cuda else None

    def upload(self, obs: np.ndarray, dones: np.ndarray, obs_dev, dones_dev):
        """Queues the copy of a step's obs and dones to the device."""
        if self.cuda:
            # The last copy out of these buffers must be over before they
            # are refilled.
            self.inputs_copied.synchronize()
        self.obs.numpy()[...] = obs
        self.dones.numpy()[...] = dones
        obs_dev.copy_(self.obs, non_blocking=True)
        dones_dev.copy_(self.dones, non_blocking=True)
        if self.cuda:
            self.inputs_copied.record(self.stream)

    def download(self, actions: torch.Tensor) -> None:
        """Queues the copy of a step's actions to the host."""
        self.actions.copy_(actions, non_blocking=True)
        if self.cuda:
            self.actions_copied.record(self.stream)

    def host_actions(self) -> np.ndarray:
        """The actions of the last ``download``, once they are on the host:
        waits for that copy and for nothing queued after it. Valid until
        the next ``download``."""
        if self.cuda:
            self.actions_copied.synchronize()
        return self.actions.numpy()


class HostRolloutFn:
    """Collects ``worker_steps`` steps of all workers of a host env with
    ``model``; actions are drawn from ``generator`` (on the model's device).
    ``pipeline=True`` (the default) splits the workers into groups that
    overlap one group's host env step with the others' policy steps (see
    the module's docstring); ``n_groups`` is 1 without it. With a ``mesh``,
    ``env`` holds this rank's workers."""

    def __init__(self, config: TrainConfig, env, model: ActorCriticModel,
                 generator: Optional[torch.Generator],
                 pipeline: bool = True, mesh: Optional[DataMesh] = None):
        if config.obs_uint8:
            raise ValueError(
                "obs_uint8 is not supported with a host env: the JAX "
                "package's host rollout stores float observations that its "
                "update then divides by 255, so the two packages would "
                "train on different inputs")
        self.config = config
        self.env = env
        self.model = model
        self.generator = generator
        self.device = model.lin_hidden.weight.device
        self.max_ep = env.max_episode_steps
        L = config.transformer.memory_length
        self.mask_table = torch.as_tensor(build_memory_mask(L),
                                          device=self.device)
        self.index_table = torch.as_tensor(
            build_memory_indices(self.max_ep, L), device=self.device)
        self.mesh = mesh
        W = config.n_workers
        rows = slice(0, W) if mesh is None else mesh.worker_rows(W)
        self.n_workers = rows.stop - rows.start
        groups = max(1, config.host_pipeline_groups) if pipeline else 1
        if not hasattr(env, "step_group"):
            groups = 1
        if mesh is not None and self.n_workers % groups != 0:
            raise ValueError(
                f"host_pipeline_groups ({groups}) must divide the workers of "
                f"a rank, n_workers / num_devices = {W} / {mesh.size} = "
                f"{self.n_workers}")
        while groups > 1 and self.n_workers % groups != 0:
            groups -= 1
        self.n_groups = groups

    def init_state(self) -> HostRolloutState:
        trx = self.config.transformer
        W = self.n_workers
        try:
            self.env.start(W, n_groups=self.n_groups)
        except TypeError:  # engines without group support
            self.n_groups = 1
            self.env.start(W)
        obs = self.env.reset_all()
        return HostRolloutState(
            obs=obs,
            episode_step=torch.zeros(W, dtype=torch.int64,
                                     device=self.device),
            memory=torch.zeros(W, self.max_ep, trx.num_blocks, trx.embed_dim,
                               device=self.device))

    def group_rows(self, group: int) -> slice:
        """The workers of ``group`` (of this rank's)."""
        Wg = self.n_workers // self.n_groups
        return slice(group * Wg, (group + 1) * Wg)

    def sample_actions(self, logits, step: int, group: int):
        """Actions and log-probs of ``group``'s workers at ``step``; one
        method so that a test can inject the JAX package's actions. Under a
        mesh the uniforms are drawn for that group of every rank."""
        del step, group
        if self.mesh is None:
            return distributions.sample_multi(logits, self.generator)
        Wg = logits[0].shape[0]
        return distributions.sample_multi(
            logits, self.generator,
            slice(self.mesh.rank * Wg, (self.mesh.rank + 1) * Wg),
            Wg * self.mesh.size)

    @torch.no_grad()
    def __call__(self, state: HostRolloutState
                 ) -> Tuple[HostRolloutState, RolloutBatch]:
        cfg = self.config
        W, T, G = self.n_workers, cfg.worker_steps, self.n_groups
        Wg = W // G
        dev = self.device
        model = self.model
        obs_shape = tuple(self.env.observation_shape)
        n_br = len(self.env.action_branches)
        L = cfg.transformer.memory_length

        snapshot = state.memory
        memory = snapshot.clone()
        slots = torch.arange(self.max_ep, device=dev).expand(W, -1)
        k_cache, v_cache = model.project_memory(memory, slots)
        pe_k, pe_v = model.pe_kv()
        kv_step = KVCacheStep(model, Wg, self.max_ep, L, dev)
        group_workers = torch.arange(Wg, device=dev)

        out = dict(
            obs=torch.empty((W, T) + obs_shape, device=dev),
            actions=torch.empty(W, T, n_br, dtype=torch.int64, device=dev),
            log_probs=torch.empty(W, T, n_br, device=dev),
            values=torch.empty(W, T, device=dev),
            episode_steps=torch.empty(W, T, dtype=torch.int64, device=dev),
            tape=torch.empty((W, T) + tuple(memory.shape[2:]), device=dev))
        rewards = np.empty((T, W), np.float32)
        dones = np.empty((T, W), bool)
        info_lists: List[List[Optional[Dict]]] = [[None] * W
                                                  for _ in range(T)]

        rows = [self.group_rows(g) for g in range(G)]
        staging = [_Staging(Wg, obs_shape, n_br, dev) for _ in range(G)]
        obs_dev = [torch.empty((Wg,) + obs_shape, device=dev)
                   for _ in range(G)]
        done_dev = [torch.empty(Wg, dtype=torch.bool, device=dev)
                    for _ in range(G)]
        episode_step = [state.episode_step[r].clone() for r in rows]
        # The episode steps again on the host, where they cost no sync.
        steps_host = state.episode_step.cpu().numpy()
        steps_host = [steps_host[r] for r in rows]
        obs_host = [np.asarray(state.obs[r]) for r in rows]
        prev_dones = [np.zeros(Wg, bool) for _ in range(G)]

        def launch(g: int, t: int) -> None:
            """Queues group g's policy step for step t: the obs and pending
            done-resets to the card, the policy, the actions back."""
            r = rows[g]
            staging[g].upload(obs_host[g], prev_dones[g], obs_dev[g],
                              done_dev[g])
            mem, kc, vc = memory[r], k_cache[r], v_cache[r]
            e = episode_step[g]
            if prev_dones[g].any():   # known on the host: no sync
                d4 = done_dev[g][:, None, None, None]
                mem.masked_fill_(d4, 0.0)
                kc.copy_(torch.where(d4, pe_k, kc))
                vc.copy_(torch.where(d4, pe_v, vc))
                e = torch.where(done_dev[g], 0, e)
            logits, value, mem_item, slot, k_item, v_item = kv_step(
                obs_dev[g], kc, vc, e)
            mem[group_workers, slot] = mem_item
            kc[group_workers, slot] = k_item
            vc[group_workers, slot] = v_item
            actions, log_probs = self.sample_actions(logits, t, g)
            staging[g].download(actions)
            out["obs"][r, t] = obs_dev[g]
            out["actions"][r, t] = actions
            out["log_probs"][r, t] = log_probs
            out["values"][r, t] = value
            out["episode_steps"][r, t] = e
            out["tape"][r, t] = mem_item
            episode_step[g] = e + 1
            steps_host[g] = np.where(prev_dones[g], 0, steps_host[g]) + 1

        def env_step(g: int, t: int) -> None:
            """Waits for group g's actions of step t and steps its envs."""
            actions = staging[g].host_actions()
            if G == 1:
                obs, r, d, infos = self.env.step(actions)
            else:
                obs, r, d, infos = self.env.step_group(g, actions)
            obs_host[g] = obs
            rewards[t, rows[g]] = r
            info_lists[t][rows[g]] = infos
            # An episode that runs past max_episode_steps ends here for the
            # agent, as a truncation (done, no info): its memory is full.
            d = np.asarray(d, bool) | (steps_host[g] >= self.max_ep)
            dones[t, rows[g]] = d
            prev_dones[g] = d

        # A G-stage rotation: group g's policy step for t + 1 is queued
        # right after its env step at t, so by the time env_step(g, t + 1)
        # waits for its actions, the other groups' env steps have covered
        # the card's latency. With G = 1 this is the serial loop.
        for g in range(G):
            launch(g, 0)
        for t in range(T):
            for g in range(G):
                env_step(g, t)
                if t + 1 < T:
                    launch(g, t + 1)

        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        out["dones"], out["rewards"] = to_dev(dones.T), to_dev(rewards.T)
        new_state, advantages = self._finish(
            memory, torch.cat(episode_step), np.concatenate(obs_host),
            to_dev(np.concatenate(prev_dones)), out)
        batch = RolloutBatch(
            obs=out["obs"], actions=out["actions"],
            log_probs=out["log_probs"], values=out["values"],
            advantages=advantages, episode_steps=out["episode_steps"],
            dones=out["dones"], tape=out["tape"], snapshot=snapshot,
            episode_infos=self._episode_infos(info_lists, W, T))
        return new_state, batch

    def _finish(self, memory, episode_step, obs: np.ndarray, last_dones,
                out):
        """The pending resets, then the reference-quirk bootstrap value
        (with the last step's memory indices), then GAE."""
        cfg = self.config
        memory.masked_fill_(last_dones[:, None, None, None], 0.0)
        e = torch.where(last_dones, 0, episode_step)
        last_indices = self.index_table[out["episode_steps"][:, -1]]
        last_value = bootstrap_value(
            self.model, torch.from_numpy(obs).to(self.device), memory, e,
            self.mask_table, last_indices)
        advantages = calc_advantages(out["rewards"], out["values"],
                                     out["dones"], last_value, cfg.gamma,
                                     cfg.lamda)
        return HostRolloutState(obs=obs, episode_step=e,
                                memory=memory), advantages

    def _episode_infos(self, info_lists, W: int, T: int
                       ) -> Dict[str, torch.Tensor]:
        """Episode infos as dense (W, T) arrays, valid where done, keyed by
        the env's info keys and every scalar key the infos carried, sorted."""
        keys = set(self.env.info_keys)
        for infos in info_lists:
            for info in infos:
                if info:
                    keys.update(k for k, v in info.items()
                                if np.isscalar(v) or isinstance(v, bool))
        arrays = {k: np.zeros((W, T), np.float32) for k in sorted(keys)}
        for t, infos in enumerate(info_lists):
            for w, info in enumerate(infos):
                if info:
                    for k in arrays:
                        arrays[k][w, t] = float(info.get(k, 0.0))
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in arrays.items()}
