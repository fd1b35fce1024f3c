// Guided job-creation wizard (reference pages/JobCreate): four steps —
// basics, replicas/resources, TPU slice (pickers validated against the
// operator's own tpu/topology.py via /tpu/topologies + /tpu/validate),
// review & submit. The flat one-page form stays at #/submit for power
// users; this flow is for first-time slice sizing.
import { api, esc, navigate, params, t } from "../app.js";

const KIND_ROLES = {
  PyTorchJob: ["Master", "Worker"],
  TFJob: ["Chief", "PS", "Worker", "Evaluator"],
  JAXJob: ["Worker"],
  MPIJob: ["Launcher", "Worker"],
  XGBoostJob: ["Master", "Worker"],
  XDLJob: ["Scheduler", "PS", "Worker"],
  MarsJob: ["Scheduler", "WebService", "Worker"],
  ElasticDLJob: ["Master"],
};
const SPEC_FIELD = {
  PyTorchJob: "pytorchReplicaSpecs", TFJob: "tfReplicaSpecs",
  JAXJob: "jaxReplicaSpecs", MPIJob: "mpiReplicaSpecs",
  XGBoostJob: "xgbReplicaSpecs", XDLJob: "xdlReplicaSpecs",
  MarsJob: "marsReplicaSpecs", ElasticDLJob: "elasticdlReplicaSpecs",
};
const MAIN_CONTAINER = {
  PyTorchJob: "pytorch", TFJob: "tensorflow", JAXJob: "jax", MPIJob: "mpi",
  XGBoostJob: "xgboost", XDLJob: "xdl", MarsJob: "mars",
  ElasticDLJob: "elasticdl",
};

export async function viewJobCreate(app) {
  const q = params();
  // cross-page prefill (DataSheets "use in job")
  const state = {
    step: 0,
    kind: "JAXJob", name: "", ns: "default", image: "", cmd: "",
    roles: {},                       // role -> {count, cpu, mem, tpu}
    tpu: null,                       // validated slice or null
    data: q.get("data") || "", code: q.get("code") || "",
    tb: false, logdir: "",
    elastic: false,
  };
  const [topoRes, dsRes, csRes, nsRes] = await Promise.allSettled([
    api("/tpu/topologies"), api("/datasource"), api("/codesource"),
    api("/kubedl/namespaces")]);
  const catalog = topoRes.status === "fulfilled" ? topoRes.value : [];
  const dataSources = dsRes.status === "fulfilled" ? dsRes.value : {};
  const codeSources = csRes.status === "fulfilled" ? csRes.value : {};
  const namespaces = nsRes.status === "fulfilled" ? nsRes.value : ["default"];

  const STEPS = [
    { id: "basics", label: t("wizard.basics"), render: stepBasics },
    { id: "replicas", label: t("wizard.replicas"), render: stepReplicas },
    { id: "tpu", label: t("wizard.tpu"), render: stepTPU },
    { id: "review", label: t("wizard.review"), render: stepReview },
  ];

  function shell() {
    app.innerHTML = `
      <div class="panel"><h2>${esc(t("wizard.title"))}</h2>
        <div class="steps">${STEPS.map((s, i) => `
          <span class="step ${i === state.step ? "active" :
            i < state.step ? "done" : ""}">${i + 1}. ${esc(s.label)}</span>`)
          .join("<span class='muted'>&rarr;</span>")}</div>
        <div id="wiz-body"></div>
        <div class="row" style="margin-top:12px">
          <button id="wiz-back" ${state.step === 0 ? "hidden" : ""}>
            ${esc(t("wizard.back"))}</button>
          <span style="flex:1"></span>
          <span id="wiz-msg" class="error"></span>
          <button class="primary" id="wiz-next">
            ${state.step === STEPS.length - 1
              ? esc(t("submit.create")) : esc(t("wizard.next"))}</button>
        </div>
      </div>`;
    app.querySelector("#wiz-back").onclick = () => { state.step--; shell(); };
    app.querySelector("#wiz-next").onclick = next;
    STEPS[state.step].render(app.querySelector("#wiz-body"));
  }

  async function next() {
    const msg = app.querySelector("#wiz-msg");
    msg.textContent = "";
    try {
      await STEPS[state.step].collect(app.querySelector("#wiz-body"));
    } catch (e) { msg.textContent = e.message; return; }
    if (state.step < STEPS.length - 1) { state.step++; shell(); return; }
    try {
      const r = await api("/job/submit", { method: "POST",
        body: JSON.stringify(buildManifest()) });
      app.innerHTML = `<div class="panel"><h2>${esc(t("wizard.created"))}</h2>
        <p><a href="#/job?kind=${esc(state.kind)}&ns=${esc(r.namespace)}` +
        `&name=${esc(r.name)}">${esc(r.namespace)}/${esc(r.name)}</a></p>
        </div>`;
    } catch (e) { msg.textContent = e.message; }
  }

  // ---- step 1: basics --------------------------------------------------
  function stepBasics(el) {
    el.innerHTML = `
      <div class="form-grid">
        <label>Kind</label>
        <select id="w-kind">${Object.keys(KIND_ROLES).map(k =>
          `<option ${k === state.kind ? "selected" : ""}>${k}</option>`)
          .join("")}</select>
        <label>Name</label>
        <input id="w-name" value="${esc(state.name)}" placeholder="my-job">
        <label>Namespace</label>
        <input id="w-ns" list="w-nss" value="${esc(state.ns)}">
        <datalist id="w-nss">${namespaces.map(n =>
          `<option value="${esc(n)}">`).join("")}</datalist>
        <label>Image</label>
        <input id="w-image" value="${esc(state.image)}"
               placeholder="gcr.io/project/train:latest">
        <label>Command</label>
        <input id="w-cmd" value="${esc(state.cmd)}"
               placeholder="python train.py">
      </div>`;
  }
  stepBasics.collect = el => {
    state.kind = el.querySelector("#w-kind").value;
    state.name = el.querySelector("#w-name").value.trim();
    state.ns = el.querySelector("#w-ns").value.trim() || "default";
    state.image = el.querySelector("#w-image").value.trim();
    state.cmd = el.querySelector("#w-cmd").value.trim();
    if (!state.name) throw new Error(t("wizard.nameRequired"));
    if (!/^[a-z0-9]([a-z0-9-]*[a-z0-9])?$/.test(state.name))
      throw new Error(t("wizard.nameInvalid"));
    if (!state.image) throw new Error(t("wizard.imageRequired"));
  };

  // ---- step 2: replicas & resources -----------------------------------
  function stepReplicas(el) {
    el.innerHTML = KIND_ROLES[state.kind].map(role => {
      const r = state.roles[role] ||
        { count: role === "Worker" || role === "Master" ||
                 role === "Launcher" || role === "Chief" ||
                 role === "Scheduler" ? 1 : 0,
          cpu: "", mem: "" };
      return `
      <div class="replica-card"><h4>${role}</h4><div class="form-grid">
        <label>Replicas</label>
        <input type="number" min="0" value="${r.count}"
               data-count="${role}">
        <label>CPU</label>
        <input data-cpu="${role}" value="${esc(r.cpu)}" placeholder="4">
        <label>Memory</label>
        <input data-mem="${role}" value="${esc(r.mem)}" placeholder="8Gi">
      </div></div>`;
    }).join("");
  }
  stepReplicas.collect = el => {
    state.roles = {};
    let total = 0;
    for (const role of KIND_ROLES[state.kind]) {
      const count = parseInt(
        el.querySelector(`[data-count="${role}"]`).value || "0");
      total += count;
      state.roles[role] = {
        count,
        cpu: el.querySelector(`[data-cpu="${role}"]`).value.trim(),
        mem: el.querySelector(`[data-mem="${role}"]`).value.trim(),
      };
    }
    if (!total) throw new Error(t("wizard.replicasRequired"));
  };

  // ---- step 3: TPU slice ----------------------------------------------
  function stepTPU(el) {
    const gens = catalog.map(g => g.generation);
    const cur = state.tpu || {};
    el.innerHTML = `
      <p class="muted">${esc(t("wizard.tpuHint"))}</p>
      <div class="form-grid">
        <label>Generation</label>
        <select id="w-gen"><option value="">none (CPU)</option>
          ${gens.map(g => `<option ${g === cur.generation ? "selected" : ""}>
            ${g}</option>`).join("")}</select>
        <label>Slice</label>
        <select id="w-slice" disabled></select>
        <label>Topology</label>
        <input id="w-topo" placeholder="2x2x4" disabled
               value="${esc(cur.topology || "")}">
        <label></label><span id="w-spec" class="muted"></span>
      </div>`;
    const genSel = el.querySelector("#w-gen");
    const sliceSel = el.querySelector("#w-slice");
    const topoInp = el.querySelector("#w-topo");
    const specOut = el.querySelector("#w-spec");
    const fillSlices = () => {
      const g = catalog.find(c => c.generation === genSel.value);
      sliceSel.disabled = topoInp.disabled = !g;
      specOut.textContent = "";
      if (!g) { sliceSel.innerHTML = ""; return; }
      sliceSel.innerHTML = g.choices.map(c => `
        <option value="${esc(c.acceleratorType)}"
          ${cur.acceleratorType === c.acceleratorType ? "selected" : ""}>
          ${esc(c.acceleratorType)} &middot; ${esc(c.topology)}
          (${c.chips} chips / ${c.hosts} host${c.hosts > 1 ? "s" : ""})
        </option>`).join("");
      syncTopo();
    };
    const syncTopo = () => {
      const g = catalog.find(c => c.generation === genSel.value);
      const choice = g && g.choices.find(
        c => c.acceleratorType === sliceSel.value);
      if (choice) {
        topoInp.value = choice.topology;
        specOut.textContent =
          `${choice.chips} chips over ${choice.hosts} host(s)`;
      }
    };
    genSel.onchange = fillSlices;
    sliceSel.onchange = syncTopo;
    fillSlices();
  }
  stepTPU.collect = async el => {
    const gen = el.querySelector("#w-gen").value;
    if (!gen) { state.tpu = null; return; }
    const accel = el.querySelector("#w-slice").value;
    const topo = el.querySelector("#w-topo").value.trim();
    // server-side validation through the SAME tpu/topology.py the
    // admission chain runs — the wizard can never submit a slice the
    // operator would reject
    state.tpu = await api("/tpu/validate", { method: "POST",
      body: JSON.stringify({ acceleratorType: accel, topology: topo }) });
    state.tpu.generation = gen;
  };

  // ---- step 4: review --------------------------------------------------
  function stepReview(el) {
    el.innerHTML = `
      <div class="form-grid">
        <label>${esc(t("wizard.dataSource"))}</label>
        <select id="w-data"><option value="">none</option>
          ${Object.keys(dataSources).map(n => `<option
            ${state.data === n ? "selected" : ""}>${esc(n)}</option>`)
            .join("")}</select>
        <label>${esc(t("wizard.codeSource"))}</label>
        <select id="w-code"><option value="">none</option>
          ${Object.keys(codeSources).map(n => `<option
            ${state.code === n ? "selected" : ""}>${esc(n)}</option>`)
            .join("")}</select>
        <label>TensorBoard</label>
        <span><input type="checkbox" id="w-tb" ${state.tb ? "checked" : ""}>
          <input id="w-logdir" value="${esc(state.logdir)}"
                 placeholder="/workspace/logs"></span>
        <label>${esc(t("wizard.elastic"))}</label>
        <span><input type="checkbox" id="w-elastic"
          ${state.elastic ? "checked" : ""}>
          <span class="muted">${esc(t("wizard.elasticHint"))}</span></span>
      </div>
      <h4>${esc(t("submit.preview"))}</h4>
      <pre id="w-manifest"></pre>`;
    const refresh = () => {
      stepReview.collectLocal(el);
      el.querySelector("#w-manifest").textContent =
        JSON.stringify(buildManifest(), null, 2);
    };
    el.querySelectorAll("select,input").forEach(x => x.onchange = refresh);
    refresh();
  }
  stepReview.collectLocal = el => {
    state.data = el.querySelector("#w-data").value;
    state.code = el.querySelector("#w-code").value;
    state.tb = el.querySelector("#w-tb").checked;
    state.logdir = el.querySelector("#w-logdir").value.trim();
    state.elastic = el.querySelector("#w-elastic").checked;
  };
  stepReview.collect = el => stepReview.collectLocal(el);

  function buildManifest() {
    const specs = {};
    for (const [role, r] of Object.entries(state.roles)) {
      if (!r.count) continue;
      const limits = {};
      if (r.cpu) limits.cpu = r.cpu;
      if (r.mem) limits.memory = r.mem;
      if (state.tpu && (role === "Worker" || role === "Master"))
        limits["google.com/tpu"] = String(state.tpu.chipsPerHost);
      const container = {
        name: MAIN_CONTAINER[state.kind], image: state.image,
        ...(state.cmd ? { command: ["sh", "-c", state.cmd] } : {}),
        ...(Object.keys(limits).length ? { resources: { limits } } : {}),
      };
      const podSpec = { containers: [container] };
      if (state.data && dataSources[state.data]) {
        const ds = dataSources[state.data];
        container.volumeMounts = [{
          name: "data", mountPath: ds.local_path || "/data" }];
        podSpec.volumes = [{ name: "data",
          persistentVolumeClaim: { claimName: ds.pvc_name } }];
      }
      specs[role] = { replicas: r.count, restartPolicy: "Never",
                      template: { spec: podSpec } };
    }
    const manifest = {
      apiVersion: "training.kubedl.io/v1alpha1", kind: state.kind,
      metadata: { name: state.name, namespace: state.ns, annotations: {} },
      spec: { [SPEC_FIELD[state.kind]]: specs },
    };
    if (state.tpu) {
      manifest.spec.tpuPolicy = {
        accelerator: state.tpu.generation,
        topology: state.tpu.topology,
      };
    }
    if (state.code && codeSources[state.code]) {
      const cs = codeSources[state.code];
      manifest.metadata.annotations["kubedl.io/git-sync-config"] =
        JSON.stringify({ source: cs.code_path,
          branch: cs.default_branch || "main",
          destPath: cs.local_path || "/workspace/code" });
    }
    if (state.tb)
      manifest.metadata.annotations["kubedl.io/tensorboard-config"] =
        JSON.stringify({ logDir: state.logdir || "/workspace/logs" });
    if (state.elastic)
      manifest.metadata.annotations["kubedl.io/enable-elastic-training"] =
        "true";
    if (!Object.keys(manifest.metadata.annotations).length)
      delete manifest.metadata.annotations;
    return manifest;
  }

  shell();
}
