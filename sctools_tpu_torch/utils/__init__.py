"""Host helpers of the port: background-thread prefetching (``prefetch``)."""
