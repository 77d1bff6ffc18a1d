"""Static-batch LM serving (the port of ``repro.serve``'s prefill and
sampling): prompt ingestion into a contiguous decode cache and the greedy
or sampled generation loop.  The continuous-batching engine over a paged
pool comes with ROADMAP A.12."""

from repro_torch.serve.prefill import greedy_generate, merge_prefill_cache
from repro_torch.serve.sampling import sample_tokens

__all__ = ["greedy_generate", "merge_prefill_cache", "sample_tokens"]
