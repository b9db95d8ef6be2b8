"""Rate-limit-aware parallel map for remote model calls.

Mirrors the reference's DialLimitedResources + map_with_resource_limits
(resources/dial_limited_resources.py): daily tokens are reserved up
front (fail fast with NotEnoughDailyTokensError), concurrency is bounded
by the user's minute token limit (counter total = minute limit, each task
holds its estimated tokens), the whole map runs under a computed wall-
clock timeout (estimated time x multiplier, min 5 minutes) and a
per-model lock so concurrent maps don't invalidate each other's
estimates."""

import asyncio
from collections import defaultdict
from dataclasses import dataclass
from typing import AsyncGenerator, Awaitable, Callable, Generic, TypeVar

from dial_rag_tpu_torch.errors import NotEnoughDailyTokensError
from dial_rag_tpu_torch.runtime.resource_counter import ResourceCounter
from dial_rag_tpu_torch.utils.timing import timeout

T = TypeVar("T")
U = TypeVar("U")

MIN_TIME_LIMIT_SEC = 300.0
TIME_LIMIT_MULTIPLIER = 1.5


@dataclass
class TokenStats:
    total: int
    used: int


@dataclass
class UserLimitsForModel:
    minute_token_stats: TokenStats
    day_token_stats: TokenStats


class DialLimitedResources:
    def __init__(
        self,
        get_user_limits_coro: Callable[[str], Awaitable[UserLimitsForModel]],
    ):
        self._get_user_limits_coro = get_user_limits_coro
        self._counters: dict[str, ResourceCounter] = {}
        self._user_limits: dict[str, UserLimitsForModel] = {}
        self._reserved_tokens: dict[str, int] = defaultdict(int)
        self._locks: dict[str, asyncio.Lock] = {}

    async def _get_user_limits(self, model_name: str) -> UserLimitsForModel:
        if model_name not in self._user_limits:
            self._user_limits[model_name] = await self._get_user_limits_coro(
                model_name
            )
        return self._user_limits[model_name]

    async def get_minute_token_limit(self, model_name: str) -> int:
        return (await self._get_user_limits(model_name)).minute_token_stats.total

    async def get_day_token_limit(self, model_name: str) -> int:
        return (await self._get_user_limits(model_name)).day_token_stats.total

    async def reserve_daily_tokens(self, model_name: str, expected_tokens: int):
        limits = await self._get_user_limits(model_name)
        if limits.day_token_stats.total <= 0:
            return  # no configured day limit means unlimited, not zero
        reserved = self._reserved_tokens[model_name]
        available = limits.day_token_stats.total - limits.day_token_stats.used
        if expected_tokens + reserved > available:
            raise NotEnoughDailyTokensError(
                f"Not enough daily tokens for {model_name}: need "
                f"{expected_tokens}, reserved {reserved}, used "
                f"{limits.day_token_stats.used} of "
                f"{limits.day_token_stats.total}"
            )
        self._reserved_tokens[model_name] += expected_tokens

    async def get_counter(self, model_name: str) -> ResourceCounter:
        if model_name not in self._counters:
            minute_limit = await self.get_minute_token_limit(model_name)
            if minute_limit <= 0:
                # no configured limit: effectively unbounded concurrency
                minute_limit = 1_000_000_000
            self._counters[model_name] = ResourceCounter(minute_limit)
        return self._counters[model_name]

    def get_lock(self, model_name: str) -> asyncio.Lock:
        if model_name not in self._locks:
            self._locks[model_name] = asyncio.Lock()
        return self._locks[model_name]


class AsyncGeneratorWithTotal(Generic[T]):
    def __init__(self, agen: AsyncGenerator[T, None], total: int):
        self.agen = agen
        self.total = total


@dataclass
class _PacingPlan:
    """Token-budget pacing derived from the user's per-minute limit."""

    task_units: int  # counter units one in-flight task holds
    deadline_sec: float  # wall-clock budget for the whole map
    eta_minutes: float  # user-facing estimate (minutes)
    minute_budget: int  # effective tokens-per-minute budget

    @property
    def is_slow(self) -> bool:
        return self.eta_minutes > 1


def _plan_pacing(
    minute_token_limit: int,
    estimated_task_tokens: int,
    n_items: int,
    time_limit_multiplier: float,
    min_time_limit_sec: float,
) -> _PacingPlan:
    total_tokens = estimated_task_tokens * n_items
    budget = minute_token_limit
    if budget <= 0:
        # no configured minute limit means unlimited: pace by a generous
        # default concurrency instead of dividing by zero
        budget = max(total_tokens, estimated_task_tokens * 16, 1)
    eta_minutes = float(total_tokens) / budget
    return _PacingPlan(
        # a per-task estimate above the whole minute budget would make
        # acquire() raise; clamp so such tasks serialize instead
        task_units=min(estimated_task_tokens, budget),
        deadline_sec=max(
            eta_minutes * 60.0 * time_limit_multiplier, min_time_limit_sec
        ),
        eta_minutes=eta_minutes,
        minute_budget=budget,
    )


async def map_with_resource_limits(
    dial_limited_resources: DialLimitedResources,
    items: AsyncGeneratorWithTotal[T],
    coro_func: Callable[[T], Awaitable[U]],
    estimated_task_tokens: int,
    model_name: str,
    file,
    time_limit_multiplier: float = TIME_LIMIT_MULTIPLIER,
    min_time_limit_sec: float = MIN_TIME_LIMIT_SEC,
    progress: Callable[[], None] | None = None,
) -> list[U]:
    await dial_limited_resources.reserve_daily_tokens(
        model_name, estimated_task_tokens * items.total
    )
    plan = _plan_pacing(
        await dial_limited_resources.get_minute_token_limit(model_name),
        estimated_task_tokens,
        items.total,
        time_limit_multiplier,
        min_time_limit_sec,
    )
    if plan.is_slow:
        file.write(
            f"This will take roughly {plan.eta_minutes:.1f} minutes:"
            f" {model_name} allows {plan.minute_budget} tokens/minute"
            f" for this account.\n\n"
        )

    resource_counter = await dial_limited_resources.get_counter(model_name)
    tasks: list[asyncio.Task] = []

    # The lock serializes maps on the same model: the deadline was computed
    # for this map alone.
    async with dial_limited_resources.get_lock(model_name):
        async with timeout(plan.deadline_sec):
            async with asyncio.TaskGroup() as task_group:
                async for item in items.agen:
                    task = await resource_counter.acquire_and_create_task(
                        coro_func(item), plan.task_units, task_group
                    )
                    if progress is not None:
                        task.add_done_callback(lambda _: progress())
                    tasks.append(task)

    return [task.result() for task in tasks]
