"""Process-wide serialization of device (PJRT) API calls.

The reference has no analogue — its realtime thread owns all DSP and the
codec threads are pure CPU (``src/module/monitor.rs:185-251``).  Here the
codec/decode threads also use the accelerator (scaling, RGB<->YUV, plane
fetches) beside the engine thread's dispatches and fetches.

On a single device there is little to gain from concurrent client calls —
the device queues them anyway — so every device touch from every thread
takes this RLock, and the order of device calls stays that of the
threads' critical sections.  Critical sections are kept tight (one dispatch or one fetch);
an RLock so nested sections (engine tick -> video mixer -> scale) are fine.
"""

import threading

DEVICE_LOCK = threading.RLock()
