"""Salca core in PyTorch: quantization, selection and the paged KV cache."""

from repro_torch.core.cache import (
    PagedSalcaCache, SalcaCache, adopt_pages, append_token, append_token_masked,
    append_token_paged, cache_bytes, cow_block, empty_cache, empty_paged_cache, free_pages,
    map_block, paged_cache_bytes, prefill_cache, prefill_into_pages, reset_slot, share_blocks,
    write_prefill_into_slot)

__all__ = [
    "SalcaCache", "empty_cache", "prefill_cache", "append_token", "append_token_masked",
    "cache_bytes", "write_prefill_into_slot", "reset_slot", "PagedSalcaCache",
    "empty_paged_cache", "prefill_into_pages", "adopt_pages", "append_token_paged",
    "map_block", "free_pages", "paged_cache_bytes", "share_blocks", "cow_block"]
