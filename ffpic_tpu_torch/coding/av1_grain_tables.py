"""AV1 film-grain Gaussian_Sequence (GENERATED by
tools/extract_av1_grain_tables.py - do not edit).

Normative spec constants (7.18.3.2), machine-extracted from the
system dav1d binary.

Copied from ``ffpic_tpu/coding/av1_grain_tables.py`` for the PyTorch
port unchanged.
"""

import base64
import zlib

import numpy as np

_BLOB = (
    "eNoVVy2UeV8X3vucO+8SBEEQBEEQBEEQBGGCIAgTBEEQBEEQBEEQBEEQBEEQBEEQBEEQJgiCIAiC"
    "IAiC4P9zzt7vM2vWums+7hz74/k6OcqZki6pS0s8d9p1McraK12Dm43wW5uuK0k/0W9N2Ba1/U4G"
    "MqRAH1zRND1cyWz8i+MapoWJcFIOdqpD0+IV5zXjC3q3axmajp793DvdUVI7+N1B2zzTke/SXYcc"
    "Ny+daM8c+UUZXWqLnz7u35RzK1czHd7rRc5aV0cXedOV7jLisL5oryVa6Ymi5od7dNGcncle3zLT"
    "qZ9xwV8oi1Nrug8a0rdljtIKf7u7DGfopplP81OQxt+Z/kV5KjmivA9zk+p88XdeCCpFFwkdmahO"
    "PnkKaEhRrvqBLGisRw5R1hToSVk+SUtyeD9HHWrIUNf85pgWuWSr6CdiK3qnhFZ5ID3Mu0bJz1Wi"
    "XLYFO5ER+u7JWqZyNl2ZUUFPnOIrPuvtphrjgPaURncdP7cRGn/FKWJSNrBRCnOF1nKTLvWkIEeK"
    "6+OzkbHpclNPUjJPips4DWihJSGcGXOdL6KjJoKOhjDj5adj4rLyC4nbLtU9+T5HvmLYdU6v4jTL"
    "daoocVgOFMgAW2zzUwYadWd/8T1JmrMseaxvbbmtJHShI03qVG/25pKmwSld05JzmtYx1WhMcT5T"
    "XXbSoZP0ZO73fi1vLWlZN6aNKtumhE6dfwIF2DetfIUPkpe4RmlsU/91dCkXN6QUETb+pg1FpWfr"
    "OrdDX+SyL8jER/xUMyZwa7q6HfBRMOlgyGOTMmO9aYGHPsdznWtKwhwhvGlq/gA0TzXgHsc5yRlM"
    "r0INfdlUENc5DeTHl01HptjDy+906GZU1q4ZmDG3pSQ1u+CUv9i5H9iVT3FCY6asDbfmo04CvM1v"
    "9+uGLmwu/uC3WtWZrk2TSz7stvjUhDTt/LPntcyka3effVD1YaDyRU9u8xUI+KUWFYHcGHV9ERgr"
    "y5XSLsJORlSSOde5iW2WaEkxP5IxR3xNlqbsi9j/jKu05StvtPNvTs3PFqcsOMSRoEct9/JTKVDT"
    "vjTA/KNg8MsXOMqBLG2MWtj1y+Tpga3VqcNx8G6qcT9WJ0V+oYqc1mRDc/T10BTnqWsHLk9z+qaQ"
    "P9NZMBG56Zin8uszmvtHkuIiT6Sq9//erh/8yJxCMtIOpbQJ5mY5QQXaaJHatIIaPeXAd/90d6mC"
    "lxHf1bC5+bdr4+wfcOjoI0FK8K6bf9rUNRsT57K+7YFmruNDWueD3fgs0N6yEXPXorZpxy3N27A5"
    "UVqzFKZf8CgmTRm5nK35sw5tSF98MDv/4J2P0BHI6XGXKhzjggmLowYdZE/fwP0rSHEo+PmsOY9d"
    "lSWnTb8zCf0xqBS95KVtGxRxC97+u0tArU+LL7wxaShrjNZAeF77QNyLT9CpFzQ4wqRVKfCRWlC8"
    "KTV5z3HsMc8XbD8E1SlSAyd35ckVf9QjDbUhmLnvgI8bF7FZKMrVd+UtQ3t1Qz/1vz5vkkBygp96"
    "wIxH2vchH+O6X/0hh/Ja/VNQ3lPZnDQsK95i0l2z1gHUpy5x47C1qVw0Av3eaUj3qL4AnY4EVSj4"
    "43PVFKYyph119O1zdHQJvZgBkHmCQlckAn0omdS/gjnwEaqeo60HC/+NNCK/6DFLbc1Amfb6Q0Xw"
    "u09TeclEb9jLxbz9nI5y8x0q8lqz8jJ9LpkHsL+BdjRlL009mLkfA+ULHYBVK1tBpQvZ2TMfoMQ7"
    "06GCjYN3gfQpKSUb9WM5aTVYfa4fMIdTpuTzUP4atPQb/rHzV3TdtTUef95815l8c4kX/leS7ICg"
    "t97gInFwMAKFnMKhsnrSM2eBn2+NOWyRhkFHsqbOQ3ODahDfuKBvaEMHLMtDOao24U9w3jd888Ql"
    "SslfFWU39jcT0RH3KYqJ5oHeOrRiD4btZe9KVNc4E9Ru58b0pqFpmFOQ4A08qK8lc6GQKfpQQDaO"
    "GT/BuB1nZAodHvAGzxA3wN8CcHumAnC4A8pCLh+Mg5i5AcN9avNBCZto00wyeGbgT1Oe2pNETNus"
    "aWDS0J+kpr4yVOKHCZuXZHzcPNDtQjKah//1sIEOzipT3l0lZ4AJhUPaEKVMHdNa2wQ8O+svsgga"
    "2sScF97JyaWhFwO9YpbB15N3dOQcdu58H/4adsc/T9IkPfA8uy21//dNAx1qnmdAUI1TtiZlcCUh"
    "ObhkVn99G9t/oqq7cfrNNVl4smEOASdd8KwsZbpCMfdS+Kx9CEyv0k5a+P8UPGLyv5OsydmyZu1W"
    "45jamjsuCnwGsuEEnKTEB3qbIZy7Rg8d+Lc/+jJng50+fMgWzY6G8Ia3j/K3lukAXAV61AG0p+xv"
    "+NnBP+vyBMrXlIFrZmhCN15oSi92Y7b09AMzhEOC/Rymg6/RhQMdI4N1JG1Idz7gGfz0iVTlJCpF"
    "Spux+QYiArvmBdxjK+HPjLey0omd0Y1OJgGHLVCPv6mnA6SXN1LSFtmq6gaakKFfIqX92KZcpasH"
    "qtOCttjo1B04F3R5BZUi1Dhw0GmqcQWMnlPV5OGt8FtT1Bs0tQ1urNwCDnGER9yw6QeULS0b12Pi"
    "DCaSka1vYXd9MwViZv4J3cyYigw4b1P0A1VuKEEDiybGA8zu5LMuD9c+mTIqusKh4cKe8KxDed/u"
    "Zno6NyF0ENBYapQwd3p/thbehdx31jTHqOqXvk+1YAKn23xycPAtuNzlLTx+7o9fC7zzglIWoCYd"
    "mtiVWSCPZIHeOHeCQVAxC+7YESreyYXycJq0/9YjNHaOjNKXl81LE7oxs2Mu+o2+pO96mNJCXq7B"
    "ZR5xhZecNCPMPY4dH5zzP/Bn5Cokog4ybZ32SKM3eSHLzuniS9rD3+pu78I8wsSaQNQM82//lw4W"
    "/KsT6EZdjwbK7rF5OABcFF40oY4f+x9/VyROGSONvD9k1/SWAHhwSMlpjgBjJzOQnU9rAv+9o+9g"
    "7Eeug3MdqrvqN5gy5OwXEo6vUw5OMIejrqlt01CvJHeRxgp+41o8x50g7el/S9vmFg3Bk4S04I1X"
    "sKYP5ie1bkNQsMcng+Qwti9gJOHP0uATMvEYXIvaFj43YUZc81XwKQJtStNN+nJzdyjhgZZ+KH+5"
    "rO36SI4jD174nP5qFHy5AeFrW7N3m5OiPlDbGXltbgrQhaFdahpZYYisNZSuv5iwn0HdKvz2VaTG"
    "J1z3TI9PR6u+Lcl/8AxdAWOPrzmHZCFjmcgu+HF9SYMlTZ/3N/6Whs7sQCvBBQ6QwdQX0oRS36Am"
    "b86YjSw0wRFwJo40vwVyS9TnO0259cn6rn+ZH51K6C+5cMRkwOoKOLBDtQ//lDiQ+kJGOdlfDpkG"
    "TeAwC+Txm47koC90f0LnZOtBRklWBKRTE75XNQt/lCQScRo3l4Je4EItpK2m28iNIlqQlFTsCc6X"
    "x42rjtOW8HqHXNVAtWG4/sqtfJPW4HiOs0i9Kyh5AxkgpDMKTNFc/pRf7nKRuq59HDefEXJil6bI"
    "MgFct+6ce/sfGfk0p3XwSQAVCTv5pPX9b4VMjrQITd/5u1vr76eMbpF5tcsHOFkFiXROv7w1dTfC"
    "baSHG8fOOTgzdFNb/ki//mEWugCz0zilAT9oaACWRXjsGr6D20QHCSVMveCmJeTGArCURTqIGof+"
    "zxoPjqihQhE5+RqS8hLcq/OYG8h0yD568jH7l9ranMJ9ZQ2kdvB9153h62/ckza2RyPToomJ6RxT"
    "gddBhV/o6gpkEPixpaJ3cPNv3nxG5hfICHFHM9jrTre40ZahfRkzh7Y+JI+k9WOv/u9umXB/mTZH"
    "Waratj3RSxfwHTJnP7V/2WaLySyhDEVt2YZWkKW7n5M8fUqauKPF/BUJLA6lHAE5uDHoHbexGm6a"
    "a9zpx/hqUAKJ+QqWrTQBt4hxgld2iUT/f4qI69o="
)

GAUSSIAN_SEQUENCE = np.frombuffer(
    zlib.decompress(base64.decodebytes(_BLOB.encode())),
    dtype="<i2").reshape(2048).copy()
