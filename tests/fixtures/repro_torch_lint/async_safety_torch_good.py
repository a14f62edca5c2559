"""Known-good serving module: device syncs only in the worker thread."""
import asyncio

import torch


class AsyncServer:
    async def serve(self, reqs):
        return await asyncio.to_thread(self._work, reqs)

    def _work(self, reqs):
        out = self.engine.run(reqs)
        self.done.record()
        self.done.synchronize()
        torch.cuda.synchronize()
        return out
