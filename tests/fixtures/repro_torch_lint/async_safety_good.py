"""Known-good serving module: the sanctioned async idioms."""
import asyncio

import torch


class AsyncServer:
    async def serve(self, reqs):
        await asyncio.sleep(0.01)
        # the bound method passed as an argument, not called on the loop
        return await asyncio.to_thread(self._work, reqs)

    def _work(self, reqs):
        # blocking calls and device syncs belong in the worker thread
        out = self.engine.run(reqs)
        torch.cuda.synchronize()
        return out
