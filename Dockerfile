# Runtime image for pollen-tpu (CPU backend; a GPU image installs
# jax[cuda] instead). Reference analogue: the repo Dockerfile.

FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
    g++ make && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/pollen-tpu
COPY pyproject.toml README.md ./
COPY pollen_tpu ./pollen_tpu
COPY benchsuite ./benchsuite
COPY tests ./tests
COPY bench.py __graft_entry__.py Makefile ./

RUN pip install --no-cache-dir -e . "jax[cpu]" pytest && make native

CMD ["python", "-m", "pytest", "tests/", "-q"]
